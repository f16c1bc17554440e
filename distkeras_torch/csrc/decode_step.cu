// Fused single-token decode step for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel distkeras_tpu/ops/decode_step.py ::
// _decode_kernel (launched from _fused_call): one decode token through all
// L transformer blocks,
//   LN0 -> qkv -> attention over the cache (positions <= pos) -> proj +
//   residual -> LN1 -> up -> gelu(tanh) -> down + residual,
// returning the hidden state before the final norm.
//
// One persistent cooperative launch per token walks the L layers.  The TPU
// kernel carries the hidden state across a sequential grid over layers;
// Hopper blocks run in no order, so the five phases of a layer are
// separated by grid-wide barriers (cooperative_groups::this_grid().sync()),
// each phase needing all of the previous one's output.
//
// Bound: per token every block weight is read once (12 E^2 elements per
// layer) plus the K and V cache rows 0..pos of every layer: memory-bound at
// decode batch sizes.  At the serving shape that is ~4 us of bytes per
// layer, against five barriers and five phases whose cost is latency, so
// the bf16 kernel (decode_kernel<D>) is built to take latency off each
// phase's critical path:
//
//   weights staged ahead   each gemv phase's rows are cut into m16 tiles
//                          and dealt to blocks so that every block holds a
//                          near-equal share of a layer's weight bytes (the
//                          down tiles, four times as deep, go to blocks of
//                          their own).  A block streams ITS tiles, in the
//                          order it will use them, through a ring of
//                          shared-memory slots (cp.async, completion on an
//                          mbarrier per slot), refilled as soon as a tile
//                          is consumed, so the next phases' and layers'
//                          weights are in flight across the grid barriers;
//                          after a barrier only the small activation input
//                          [B, K] is read.
//   K/V staged ahead       rows 0..pos-1 of every layer's caches do not
//                          change during the step, so they stream through a
//                          second ring the same way, a layer ahead; only
//                          the new row at pos is read after the qkv phase.
//   gemv on tensor cores   out[N, B] = W[N, K] . X[B, K]^T with mma.sync
//                          m16n8k16 (bf16 in, f32 accumulate): weight rows
//                          are the A operand (ldmatrix from the slot), the
//                          batch is n (one n-tile for B <= 8, two for
//                          B <= 16, missing rows are zeros).  The K of a
//                          tile is split across the 8 warps and the partial
//                          sums are added in shared memory in warp order.
//   attention on every SM  each (b, h) pair goes to a cluster of 2 blocks
//                          (a cooperative launch with a cluster dimension)
//                          that split its positions: each half computes its
//                          scores and its local max and sum, the halves
//                          swap them through distributed shared memory in
//                          one cluster barrier, each divides by the global
//                          sum before rounding p, and the two f32 p @ V
//                          parts are added in rank order and rounded once.
//   no division on the     the rings' cursors advance step by step; the
//   critical path          per-phase tile table sits in shared memory (an
//                          array indexed at run time in registers would go
//                          to local memory).
//
// Rounding points are those of the Pallas kernel: the residual stream is
// held in the compute dtype, LN statistics are f32 (eps 1e-6), qkv, the
// softmax probabilities (divided by the global sum, then rounded), the
// attention output, the up projection and each matmul before its residual
// add are rounded to the compute dtype; gelu (tanh) takes the rounded up
// product.  Every sum runs in a fixed order and nothing is added with
// atomics, so two calls give the same bits.  The new K/V rows are written
// in place at pos; no other cache row is touched.  Caches are
// [L, B, S, H, D] (the port's prefill layout, no transpose).
//
// float32 keeps the CUDA-core design (decode_f32_kernel): a warp per output
// row, shuffle reductions, one block per (b, h) in attention.
//
// dk_decode_step_stamped runs the same bf16 kernel with timestamps
// (%globaltimer, thread 0 of block 0, after every grid barrier, plus the
// caller's count of barriers with no work before the first layer): a probe
// of where a token's time goes, not called on the serving path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#include "flash_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBatch = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-6f;

enum Mode { kLnQkv = 0, kResid = 1, kLnUp = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Loads of data this kernel also writes (hidden state, scratch rows, the
// caches) go through L2 only (ld.global.cg): an SM must not read a line its
// L1 cached before another SM rewrote it between two grid barriers.
__device__ __forceinline__ uint4 ld_cg16(const void* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}
// 16 bytes: 4 floats, or 8 bf16 widened to float
__device__ __forceinline__ void unpack_f32(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack_bf16(const uint4& raw, float* out) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

// ------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ------------------------------------------------------------------------
constexpr int kVec = 4;  // floats in 16 bytes

struct StepArgs {
  float* x;             // [B, E] hidden state, updated in place
  const float* ln;      // [L, 4, E]
  const float* wqkv;    // [L, 3HD, E]
  const float* wproj;   // [L, E, HD]
  const float* wup;     // [L, F, E]
  const float* wdown;   // [L, E, F]
  float* kc;            // [L, B, S, H, D]
  float* vc;
  float* q_buf;         // [B, HD]
  float* o_buf;         // [B, HD]
  float* h_buf;         // [B, F]
  int L, B, E, H, F, S, pos;
  float scale;
};

extern __shared__ __align__(16) unsigned char g_smem[];

// One gemv phase: the block's input rows [B, K] go to shared memory (then
// through LayerNorm for kLnQkv / kLnUp), then every warp of the grid takes output rows
// n of W [N, K].  The first chunks of a warp's first row are loaded before
// the prologue, so their memory latency overlaps it.
template <int MODE>
__device__ void gemv_phase(const float* xin, const float* ln_scale, const float* ln_bias,
                           const float* w, int N, int K, int B, float* out, float* q_out,
                           float* k_row, float* v_row, long long cache_bstride, int HD) {
  constexpr int V = kVec;
  constexpr int kPre = 8;  // 16-byte chunks per lane loaded ahead
  float* xs = reinterpret_cast<float*>(g_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // rows interleave across blocks, so a phase with few rows still uses every SM
  const int first = blockIdx.x + gridDim.x * warp;
  const int stride = gridDim.x * kWarps;

  uint4 pre[kPre];
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int k = (lane + 32 * i) * V;
    pre[i] = (first < N && k < K)
                 ? __ldg(reinterpret_cast<const uint4*>(w + (long long)first * K + k))
                 : make_uint4(0, 0, 0, 0);
  }

  // one batched copy of the input rows; LayerNorm then works in shared memory
  uint4* dst = reinterpret_cast<uint4*>(xs);
  for (int i = tid; i < B * K / V; i += kThreads) dst[i] = ld_cg16(xin + (long long)i * V);
  if (MODE == kLnQkv || MODE == kLnUp) {
    __syncthreads();
    // one warp per row, normalized in place; two-pass variance as the
    // Pallas kernel's _ln
    for (int b = warp; b < B; b += kWarps) {
      float* xr = xs + b * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += xr[k];
      const float mu = warp_sum(s) / K;
      float var = 0.f;
      for (int k = lane; k < K; k += 32) var += (xr[k] - mu) * (xr[k] - mu);
      const float rstd = rsqrtf(warp_sum(var) / K + kLnEps);
      for (int k = lane; k < K; k += 32) xr[k] = (xr[k] - mu) * rstd * ln_scale[k] + ln_bias[k];
    }
  }
  __syncthreads();

  for (int n = first; n < N; n += stride) {
    float acc[kMaxBatch];
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) acc[b] = 0.f;
    auto chunk = [&](const uint4& raw, int k) {
      float wv[V];
      unpack_f32(raw, wv);
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b < B) {
          float xv[V];
          unpack_f32(*reinterpret_cast<const uint4*>(xs + b * K + k), xv);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[b] += wv[i] * xv[i];
        }
      }
    };
    int k_rest = lane * V;
    if (n == first) {
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int k = (lane + 32 * i) * V;
        if (k < K) chunk(pre[i], k);
      }
      k_rest += kPre * 32 * V;
    }
    for (int k = k_rest; k < K; k += 32 * V) {
      chunk(__ldg(reinterpret_cast<const uint4*>(w + (long long)n * K + k)), k);
    }
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) {
      if (b < B) {
        const float val = warp_sum(acc[b]);
        if (lane == b) {
          if (MODE == kLnQkv) {
            if (n < HD) {
              q_out[b * HD + n] = val;
            } else if (n < 2 * HD) {
              k_row[b * cache_bstride + (n - HD)] = val;
            } else {
              v_row[b * cache_bstride + (n - 2 * HD)] = val;
            }
          } else if (MODE == kResid) {
            float* xo = out + (long long)b * N + n;
            *xo = ld_cg(xo) + val;
          } else {
            out[(long long)b * N + n] = gelu_tanh(val);
          }
        }
      }
    }
  }
}

__device__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = is_max ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red may still be read by an earlier reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = is_max ? -INFINITY : 0.f;
  for (int i = 0; i < kWarps; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// Shared memory of the attention phase, in floats: q [D], scores [S],
// partial p @ V sums [kThreads * kVec], reduction scratch [32].
constexpr int kAttnPartFloats = kThreads * kVec;

// Attention for one (b, h) pair on one block.  Every thread keeps one key
// row's 16-byte loads in flight (the head dim is a template constant, so
// they unroll); the p @ V pass gives each thread one 16-byte chunk of a
// value row, kThreads / (D / kVec) rows at a time.
template <int D>
__device__ void attention_item(const float* q, const float* kc, const float* vc, float* o,
                               int b, int h, int H, int S, int pos, float scale) {
  constexpr int V = kVec;
  constexpr int kChunks = D / V;             // 16-byte chunks per row
  constexpr int kRows = kThreads / kChunks;  // value rows per pass
  float* qs = reinterpret_cast<float*>(g_smem);
  float* sc = qs + D;
  float* part = sc + S;
  float* red = part + kAttnPartFloats;
  const int n = pos + 1;
  const int HD = H * D;
  const int tid = threadIdx.x;

  __syncthreads();  // shared memory free from the previous item
  for (int d = tid; d < D; d += kThreads) qs[d] = ld_cg(q + b * HD + h * D + d);
  __syncthreads();

  const long long row_stride = HD;  // between positions
  const float* kb = kc + (long long)b * S * HD + h * D;
  const float* vb = vc + (long long)b * S * HD + h * D;
  float mx = -INFINITY;
  for (int t = tid; t < n; t += kThreads) {
    const float* kr = kb + t * row_stride;
    float kv[D];
#pragma unroll
    for (int d = 0; d < D; d += V) unpack_f32(ld_cg16(kr + d), kv + d);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) dot += qs[d] * kv[d];
    const float s = dot * scale;
    sc[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int t = tid; t < n; t += kThreads) {
    const float p = expf(sc[t] - mx);
    sc[t] = p;
    sum += p;
  }
  sum = block_reduce(sum, red, false);
  for (int t = tid; t < n; t += kThreads) sc[t] = sc[t] / sum;
  __syncthreads();

  const int g = tid / kChunks, c = (tid % kChunks) * V;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int t = g; t < n; t += kRows) {
    float vv[V];
    unpack_f32(ld_cg16(vb + t * row_stride + c), vv);
    const float p = sc[t];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += p * vv[i];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) part[g * D + c + i] = acc[i];
  __syncthreads();
  for (int dd = tid; dd < D; dd += kThreads) {
    float r = 0.f;
    for (int gg = 0; gg < kRows; ++gg) r += part[gg * D + dd];
    o[b * HD + h * D + dd] = r;
  }
}

// The whole step: every block walks the layers, and the grid meets at a
// barrier between phases (each phase needs all of the previous one).  Every
// thread reaches every barrier: no thread leaves a loop early.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) decode_f32_kernel(StepArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int HD = a.H * D;
  const int E = a.E, F = a.F, B = a.B;
  const long long cache_bstride = (long long)a.S * HD;
  for (int l = 0; l < a.L; ++l) {
    const float* ln = a.ln + (long long)l * 4 * E;
    const long long layer_cache = (long long)l * B * a.S * HD;
    float* k_row = a.kc + layer_cache + (long long)a.pos * HD;
    float* v_row = a.vc + layer_cache + (long long)a.pos * HD;

    gemv_phase<kLnQkv>(a.x, ln, ln + E, a.wqkv + (long long)l * 3 * HD * E, 3 * HD, E, B,
                       nullptr, a.q_buf, k_row, v_row, cache_bstride, HD);
    grid.sync();
    for (int item = blockIdx.x; item < B * a.H; item += gridDim.x) {
      attention_item<D>(a.q_buf, a.kc + layer_cache, a.vc + layer_cache, a.o_buf,
                        item / a.H, item % a.H, a.H, a.S, a.pos, a.scale);
    }
    grid.sync();
    gemv_phase<kResid>(a.o_buf, nullptr, nullptr, a.wproj + (long long)l * E * HD, E, HD, B,
                       a.x, nullptr, nullptr, nullptr, 0, HD);
    grid.sync();
    gemv_phase<kLnUp>(a.x, ln + 2 * E, ln + 3 * E, a.wup + (long long)l * F * E, F, E, B,
                      a.h_buf, nullptr, nullptr, nullptr, 0, HD);
    grid.sync();
    gemv_phase<kResid>(a.h_buf, nullptr, nullptr, a.wdown + (long long)l * E * F, E, F, B,
                       a.x, nullptr, nullptr, nullptr, 0, HD);
    grid.sync();
  }
}

// Shared memory a block needs: the widest gemv input or the attention phase.
size_t step_smem(const StepArgs& a, int D) {
  const size_t gemv = (size_t)a.B * std::max(a.E, std::max(a.F, a.H * D)) * sizeof(float);
  const size_t attn = (size_t)(D + a.S + kAttnPartFloats + 32) * sizeof(float);
  return std::max(gemv, attn);
}

struct GridCache {
  std::mutex mu;
  int device = -1;
  size_t smem = 0;
  int blocks = 0;
};

template <int D>
cudaError_t launch_step(StepArgs a, cudaStream_t stream) {
  static GridCache cache;
  const size_t smem = step_smem(a, D);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  int blocks;
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    if (cache.device != device || cache.smem != smem) {
      if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(decode_f32_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
      }
      int sms = 0, per_sm = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (e != cudaSuccess) return e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_f32_kernel<D>,
                                                        kThreads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      cache.device = device;
      cache.smem = smem;
      // one block per SM: its registers are uncapped (__launch_bounds__(.., 1))
      cache.blocks = sms;
    }
    blocks = cache.blocks;
  }
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(decode_f32_kernel<D>),
                                  dim3(blocks), dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const StepArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_step<32>(a, stream);
    case 64: return launch_step<64>(a, stream);
    case 128: return launch_step<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using namespace flash_mma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWSlots = 8;     // weight ring
constexpr int kMaxASlots = 16;    // K/V ring
constexpr int kTileRows = 16;     // m of mma.m16n8k16
constexpr int kChunkCols = 512;   // widest weight chunk a slot holds
constexpr int kRedFloats = kWarps * kTileRows * 16;
constexpr int kCluster = 2;       // blocks that share an attention item
enum Phase { kQkv = 0, kProj = 1, kUp = 2, kDown = 3 };

// shared memory map (bytes): mbarriers, the K-split partial sums, the
// weight ring, the K/V ring, then one region that the gemv input [B, K]
// (with its LayerNorm parameters) and the attention phase take in turn
constexpr int kBarBytes = 256;
static_assert((kMaxWSlots + kMaxASlots) * 8 <= kBarBytes, "mbarriers");
constexpr int kRedOff = kBarBytes;
constexpr int kWRingOff = kRedOff + kRedFloats * 4;

struct TcArgs {
  bf16* x;                 // [B, E], updated in place
  const float* ln;         // [L, 4, E]
  const bf16* wqkv;        // [L, 3HD, E]
  const bf16* wproj;       // [L, E, HD]
  const bf16* wup;         // [L, F, E]
  const bf16* wdown;       // [L, E, F]
  bf16* kc;                // [L, B, S, H, D]
  bf16* vc;
  bf16* q_buf;             // [B, HD]
  bf16* o_buf;             // [B, HD]
  bf16* h_buf;             // [B, F]
  long long* stamps;       // null, or the probe's timestamps
  int empty_barriers;      // the probe's barriers with no work
  int L, B, E, H, F, S, pos;
  float scale;
  int kc_cols;             // weight chunk width (a slot's columns), a power of 2
  int spc_shift;           // log2(kc_cols / 16): 16-deep steps per chunk
  int wslots, aslots;      // ring depths
  int kvring_off, region_off;  // byte offsets in shared memory
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// A wait that cannot end (a fault in the rings' bookkeeping) traps after
// ~2^24 polls instead of holding the card: the launch then fails loudly.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// One gemv phase of a layer as this block sees it, kept in shared memory
// (a phase is chosen at run time when chunks are issued, and an array in
// registers indexed at run time would go to local memory).
struct PhaseTab {
  const bf16* w;           // layer 0's slab [N, K]
  int n, k;
  int first, stride, count;
  int cpt;                 // chunks per tile
};

// The tiles of phase p that this block owns: tile t = first + j * stride,
// j < count.  The down tiles (K = F deep) go one per block from block 0;
// the qkv, proj and up tiles are dealt round-robin, in that order, over
// the remaining blocks (c0: the tiles dealt before phase p), so each block
// holds a near-equal share of a layer's weight bytes.
__device__ __forceinline__ void tiles_of(int p, int c0, const TcArgs& a, PhaseTab& t) {
  const int G = gridDim.x, blk = blockIdx.x;
  const int down = a.E / kTileRows;  // the down slab is [E, F]
  const int tiles = t.n / kTileRows;
  if (p == kDown) {
    t.first = blk;
    t.stride = G;
    t.count = blk < down ? (down - blk + G - 1) / G : 0;
    return;
  }
  const int base = down < G ? down : 0, span = G - base;
  if (blk < base) {
    t.first = 0;
    t.stride = 1;
    t.count = 0;
    return;
  }
  t.first = (((blk - base) - c0) % span + span) % span;
  t.stride = span;
  t.count = t.first < tiles ? (tiles - t.first + span - 1) / span : 0;
}

// The weight ring: chunk i of the block's sequence (layer by layer, phase by
// phase, tile by tile, 16 rows x up to kc_cols columns each) goes to slot
// i % slots: every thread copies its 16-byte pieces (cp.async) and arrives
// on the slot's mbarrier when they have landed (kThreads arrivals complete
// phase (i / slots) & 1).  Every thread keeps the same cursors:
// where the next chunk to issue comes from, and the slot and phase of the
// next chunk to consume, advanced step by step (no division on the way).
struct Slot {
  int slot, parity;
};
__device__ __forceinline__ void advance(Slot& s, int n, int slots) {
  for (int i = 0; i < n; ++i) {
    if (++s.slot == slots) {
      s.slot = 0;
      s.parity ^= 1;
    }
  }
}
__device__ __forceinline__ Slot ahead(Slot s, int n, int slots) {
  s.slot += n;
  if (s.slot >= slots) {
    s.slot -= slots;
    s.parity ^= 1;
  }
  return s;  // n < slots
}

struct WRing {
  uint32_t base, bars;
  int slots, slot_bytes, pitch;  // pitch: elements per slot row (kc_cols + 8)
  int issued, consumed, total;
  const PhaseTab* tab;
  Slot head;                     // of the next chunk to consume
  int i_slot, i_layer, i_phase, i_tile, i_chunk;  // the next chunk to issue
};

__device__ __forceinline__ void first_phase(const PhaseTab* tab, int& p) {
  while (p < 4 && tab[p].count == 0) ++p;
}

__device__ __forceinline__ void issue_chunk(const TcArgs& a, WRing& r) {
  const PhaseTab& t = r.tab[r.i_phase];
  const int K = t.k;
  {
    constexpr int kPerRow = kThreads / kTileRows;  // threads a row
    const int tile = t.first + r.i_tile * t.stride;
    const int k0 = r.i_chunk * a.kc_cols;
    const int pieces = min(a.kc_cols, K - k0) / 8;
    const int row = threadIdx.x / kPerRow;
    const bf16* src = t.w + (long long)r.i_layer * t.n * K +
                      (long long)(tile * kTileRows + row) * K + k0;
    const uint32_t dst = r.base + r.i_slot * r.slot_bytes + row * r.pitch * 2;
    for (int c = threadIdx.x % kPerRow; c < pieces; c += kPerRow) {
      cp_async16(dst + c * 16, src + c * 8, 16);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                     r.bars + r.i_slot * 8)
                 : "memory");
  }
  if (++r.i_slot == r.slots) r.i_slot = 0;
  if (++r.i_chunk == t.cpt) {
    r.i_chunk = 0;
    if (++r.i_tile == t.count) {
      r.i_tile = 0;
      int q = r.i_phase + 1;
      first_phase(r.tab, q);
      if (q == 4) {
        q = 0;
        first_phase(r.tab, q);
        ++r.i_layer;
      }
      r.i_phase = q;
    }
  }
}

// every thread: issue weight chunks while a slot is free; call after a
// block-wide barrier that follows the last read of the consumed slots
__device__ __forceinline__ void refill(const TcArgs& a, WRing& r) {
  while (r.issued < r.consumed + r.slots && r.issued < r.total) {
    issue_chunk(a, r);
    ++r.issued;
  }
}

// The K/V ring of the attention phase.  Rows 0..pos-1 of every layer's
// caches do not change during the step, so the block's whole sequence of
// K/V chunks (layer by layer, item by item: its K chunks, then its V
// chunks, each up to 4096 / D rows of its half's positions below pos) is
// prefetched as slots free up, across the gemv phases; only the new row at
// pos is read after the qkv phase.  Every thread copies its 16-byte pieces
// (cp.async) and then arrives on the slot's mbarrier when they have landed
// (kThreads arrivals a phase).  No cp.async is waited on by group, so these
// copies stay in flight across the gemv phases.
template <int D>
struct AttnChunk {
  static constexpr int kRows = 4096 / D;
  static constexpr int kPitch = D + 8;  // elements per row: a 16-byte skew per row
  static constexpr int kBytes = kRows * kPitch * 2;
};

struct KVRing {
  uint32_t base, bars;
  int slots, issued, consumed, total;
  int rank;                     // this block's rank in its cluster
  int items, first_item, item_stride;
  int tb, te, npf, nck;         // this half's positions [tb, te), the npf below pos, chunks
  Slot head;                    // of the next chunk to consume
  int i_slot, i_layer, i_item, i_chunk;  // the next chunk to issue
  long long i_base;             // its item's cache offset (b, h) in a layer
};

template <int D>
__device__ __forceinline__ void kv_item_base(const TcArgs& a, KVRing& kv) {
  const int item = kv.first_item + kv.i_item * kv.item_stride;
  const int b = item / a.H, h = item - (item / a.H) * a.H;
  kv.i_base = (long long)b * a.S * a.H * D + h * D;
}

template <int D>
__device__ __forceinline__ void kv_setup(const TcArgs& a, KVRing& kv, uint32_t base, uint32_t bars) {
  using C = AttnChunk<D>;
  kv.base = base;
  kv.bars = bars;
  kv.slots = a.aslots;
  kv.rank = (int)cg::this_cluster().block_rank();
  const int nclusters = gridDim.x / kCluster, cid = blockIdx.x / kCluster, items = a.B * a.H;
  kv.first_item = cid;
  kv.item_stride = nclusters;
  kv.items = cid < items ? (items - cid + nclusters - 1) / nclusters : 0;
  const int n = a.pos + 1, half = (n + kCluster - 1) / kCluster;
  kv.tb = min(n, kv.rank * half);
  kv.te = min(n, kv.tb + half);
  kv.npf = max(0, min(kv.te, a.pos) - kv.tb);
  kv.nck = (kv.npf + C::kRows - 1) / C::kRows;
  kv.total = a.L * kv.items * 2 * kv.nck;
  kv.issued = kv.consumed = 0;
  kv.head = {0, 0};
  kv.i_slot = kv.i_layer = kv.i_item = kv.i_chunk = 0;
  kv_item_base<D>(a, kv);
}

// every thread: the next chunk's 16-byte pieces, then an arrival on its slot
template <int D>
__device__ __forceinline__ void issue_kv(const TcArgs& a, KVRing& kv) {
  using C = AttnChunk<D>;
  constexpr int TPP = D / 8;
  const int HD = a.H * D;
  const int j = kv.i_chunk < kv.nck ? kv.i_chunk : kv.i_chunk - kv.nck;
  const bf16* src = (kv.i_chunk < kv.nck ? a.kc : a.vc) +
                    (long long)kv.i_layer * a.B * a.S * HD + kv.i_base;
  const int r0 = kv.tb + j * C::kRows;
  const int rows = min(C::kRows, kv.tb + kv.npf - r0);
  const uint32_t dst = kv.base + kv.i_slot * C::kBytes;
  for (int i = threadIdx.x; i < rows * TPP; i += kThreads) {
    const int r = i / TPP, c = i % TPP;
    cp_async16(dst + (r * C::kPitch + c * 8) * 2, src + (long long)(r0 + r) * HD + c * 8, 16);
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(kv.bars +
                                                                                kv.i_slot * 8)
               : "memory");
  if (++kv.i_slot == kv.slots) kv.i_slot = 0;
  if (++kv.i_chunk == 2 * kv.nck) {
    kv.i_chunk = 0;
    if (++kv.i_item == kv.items) {
      kv.i_item = 0;
      ++kv.i_layer;
    }
    kv_item_base<D>(a, kv);
  }
}

// every thread: issue K/V chunks while a slot is free
template <int D>
__device__ __forceinline__ void refill_kv(const TcArgs& a, KVRing& kv) {
  while (kv.issued < kv.consumed + kv.slots && kv.issued < kv.total) {
    issue_kv<D>(a, kv);
    ++kv.issued;
  }
}

// LayerNorm of the B rows in shared memory, in place, one warp per row,
// 16-byte pieces; two-pass variance as the Pallas kernel's _ln; lnp =
// scale [K], bias [K].  Up to K = 1024 a lane keeps its pieces in registers
// between the passes; wider rows are read again from shared memory.
__device__ __forceinline__ void ln_write(uint4* xr, int p, int K, const float* lnp,
                                         const float (&v)[8], float mu, float rstd) {
  const float4* sp = reinterpret_cast<const float4*>(lnp + p * 8);
  const float4* bp = reinterpret_cast<const float4*>(lnp + K + p * 8);
  const float4 s0 = sp[0], s1 = sp[1], b0 = bp[0], b1 = bp[1];
  const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  uint32_t packed[4];
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    packed[i / 2] = pack_bf16((v[i] - mu) * rstd * sv[i] + bv[i],
                              (v[i + 1] - mu) * rstd * sv[i + 1] + bv[i + 1]);
  }
  xr[p] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

__device__ __forceinline__ void layer_norm_rows(bf16* xs, int pitch, int B, int K,
                                                const float* lnp) {
  constexpr int kRegPieces = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pieces = K / 8;
  for (int b = warp; b < B; b += kWarps) {
    uint4* xr = reinterpret_cast<uint4*>(xs + b * pitch);
    if (pieces <= 32 * kRegPieces) {
      float v[kRegPieces][8];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kRegPieces; ++i) {
        if (lane + 32 * i < pieces) {
          unpack_bf16(xr[lane + 32 * i], v[i]);
#pragma unroll
          for (int j = 0; j < 8; ++j) s += v[i][j];
        }
      }
      const float mu = warp_sum(s) / K;
      float var = 0.f;
#pragma unroll
      for (int i = 0; i < kRegPieces; ++i) {
        if (lane + 32 * i < pieces) {
#pragma unroll
          for (int j = 0; j < 8; ++j) var += (v[i][j] - mu) * (v[i][j] - mu);
        }
      }
      const float rstd = rsqrtf(warp_sum(var) / K + kLnEps);
#pragma unroll
      for (int i = 0; i < kRegPieces; ++i) {
        if (lane + 32 * i < pieces) ln_write(xr, lane + 32 * i, K, lnp, v[i], mu, rstd);
      }
      continue;
    }
    float s = 0.f;
    for (int p = lane; p < pieces; p += 32) {
      float v[8];
      unpack_bf16(xr[p], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[i];
    }
    const float mu = warp_sum(s) / K;
    float var = 0.f;
    for (int p = lane; p < pieces; p += 32) {
      float v[8];
      unpack_bf16(xr[p], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) var += (v[i] - mu) * (v[i] - mu);
    }
    const float rstd = rsqrtf(warp_sum(var) / K + kLnEps);
    for (int p = lane; p < pieces; p += 32) {
      float v[8];
      unpack_bf16(xr[p], v);
      ln_write(xr, p, K, lnp, v, mu, rstd);
    }
  }
}

struct Outs {
  bf16* q;                 // qkv: q rows [B, HD]
  bf16* k_row;             // qkv: the new cache rows at pos (batch stride cache_bstride)
  bf16* v_row;
  long long cache_bstride;
  bf16* out;               // resid: x [B, N]; up: h [B, N]
};

// One gemv phase of this block: its input rows [B, K] to shared memory
// (through LayerNorm for qkv and up; ln = that norm's scale, then bias),
// then its tiles on the tensor cores, each tile's weights from the ring.
// The phase P is a run-time value: the kernel holds one copy of this code,
// not four (each phase runs once a layer, and code that does not stay in
// the instruction cache is fetched again every time).
template <int D>
__device__ __forceinline__ void gemv_tc(const TcArgs& a, WRing& r, KVRing& kv, int P,
                                        const bf16* xin, const float* ln, const Outs& o,
                                        unsigned char* smem) {
  const bool kLn = P == kQkv || P == kUp;
  const bool kResid = P == kProj || P == kDown;
  const PhaseTab& til = r.tab[P];
  if (til.count == 0) {
    // idle this phase: the K/V ring, the larger of the two, is refilled
    // here, off the critical path (every block is idle in some gemv phase
    // at the usual shapes; the attention phase refills what is missing)
    refill(a, r);
    refill_kv<D>(a, kv);
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int K = til.k, N = til.n, B = a.B, PX = K + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem + a.region_off);
  float* lnp = reinterpret_cast<float*>(xs + B * PX);
  float* red = reinterpret_cast<float*>(smem + kRedOff);

  // the norm's parameters and the input rows (written by other blocks
  // before the barrier: through L2), 16 bytes a piece, 8 pieces in flight
  uint4 lnv = make_uint4(0, 0, 0, 0);
  const bool ln_piece = kLn && tid < K / 2;
  if (ln_piece) lnv = __ldg(reinterpret_cast<const uint4*>(ln) + tid);
  {
    const int pieces = K / 8, x_pieces = B * pieces;
    // piece i is (row i / pieces, column piece i % pieces): stepped, not divided
    const int drow = kThreads / pieces, dcol = kThreads - drow * pieces;
    int row = tid / pieces, col = tid - row * pieces;
    uint4 v[8];
    int rows_[8], cols_[8];
    auto load = [&](int i0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        rows_[u] = row;
        cols_[u] = col;
        if (i0 + u * kThreads < x_pieces) v[u] = ld_cg16(xin + (long long)row * K + col * 8);
        row += drow;
        col += dcol;
        if (col >= pieces) {
          col -= pieces;
          ++row;
        }
      }
    };
    auto store = [&](int i0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + u * kThreads < x_pieces) {
          *reinterpret_cast<uint4*>(xs + rows_[u] * PX + cols_[u] * 8) = v[u];
        }
      }
    };
    load(tid);
    // the weight ring's free slots are refilled while the loads are in flight
    refill(a, r);
    store(tid);
    for (int i0 = tid + 8 * kThreads; i0 < x_pieces; i0 += 8 * kThreads) {
      load(i0);
      store(i0);
    }
  }
  if (ln_piece) reinterpret_cast<uint4*>(lnp)[tid] = lnv;
  __syncthreads();
  if (kLn) {
    // K / 2 pieces of parameters: more than the threads only past K = 1024
    for (int i = kThreads + tid; i < K / 2; i += kThreads) {
      reinterpret_cast<uint4*>(lnp)[i] = __ldg(reinterpret_cast<const uint4*>(ln) + i);
    }
    __syncthreads();
    layer_norm_rows(xs, PX, B, K, lnp);
    __syncthreads();
  }

  const int nb = B > 8 ? 2 : 1, cols = nb * 8;
  const int cpt = til.cpt;
  // thread tid finishes output (row tid / cols, batch tid % cols) of a tile
  const int erow = tid / cols, eb = tid % cols;
  const bool eowner = erow < kTileRows && eb < B;
  for (int j = 0; j < til.count; ++j) {
    const int tile = til.first + j * til.stride;
    const int n = tile * kTileRows + erow;
    // a tile whose chunks are not all issued yet (the ring is shallower than
    // the phase): its slots are free since the last tile's final barrier
    if (r.issued < r.consumed + min(cpt, r.slots)) refill(a, r);
    float resid = 0.f;  // the residual, loaded while the tile is multiplied
    if (kResid && eowner) resid = ld_cg(o.out + (long long)eb * N + n);
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    // a tile deeper than the ring is taken in segments of at most `slots`
    // chunks; warp w takes a contiguous run of the segment's 16-deep steps
    for (int s0 = 0; s0 < cpt; s0 += r.slots) {
      const int nseg = min(r.slots, cpt - s0);
      const int k_lo = s0 * a.kc_cols;
      const int steps = (min(K, (s0 + nseg) * a.kc_cols) - k_lo) >> 4;
      const int w0 = warp * steps / kWarps, w1 = (warp + 1) * steps / kWarps;
      int ch = w0 >> a.spc_shift, kk = (w0 & ((1 << a.spc_shift) - 1)) << 4;
      Slot sl = ahead(r.head, ch, r.slots);
      if (w0 < w1) mbar_wait(r.bars + sl.slot * 8, sl.parity);
      for (int s = w0; s < w1; ++s) {
        if (kk == a.kc_cols) {  // into the next chunk
          kk = 0;
          sl = ahead(sl, 1, r.slots);
          mbar_wait(r.bars + sl.slot * 8, sl.parity);
        }
        uint32_t af[4];
        ldmatrix_x4(af, r.base + sl.slot * r.slot_bytes +
                            ((lane & 15) * r.pitch + kk + 8 * (lane >> 4)) * 2);
        const int kg = k_lo + (s << 4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (nt < nb) {
            const int bi = g + 8 * nt;
            uint32_t b0 = 0, b1 = 0;
            if (bi < B) {
              const bf16* xr = xs + bi * PX + kg + 2 * tq;
              b0 = *reinterpret_cast<const uint32_t*>(xr);
              b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
            }
            mma_bf16(acc[nt], af, b0, b1);
          }
        }
        kk += 16;
      }
      r.consumed += nseg;
      advance(r.head, nseg, r.slots);
      if (s0 + nseg < cpt) {
        __syncthreads();
        refill(a, r);
      }
    }
    // C fragment: c0, c1 = (row g, col 2tq..), c2, c3 = (row g + 8, col 2tq..)
    float* rw = red + warp * kTileRows * 16;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (nt < nb) {
        const int col = nt * 8 + 2 * tq;
        rw[g * 16 + col] = acc[nt][0];
        rw[g * 16 + col + 1] = acc[nt][1];
        rw[(g + 8) * 16 + col] = acc[nt][2];
        rw[(g + 8) * 16 + col + 1] = acc[nt][3];
      }
    }
    __syncthreads();
    if (eowner) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w * kTileRows * 16 + erow * 16 + eb];
      if (P == kQkv) {
        const int HD = N / 3;
        const bf16 rv = __float2bfloat16(v);
        if (n < HD) {
          o.q[eb * HD + n] = rv;
        } else if (n < 2 * HD) {
          o.k_row[eb * o.cache_bstride + (n - HD)] = rv;
        } else {
          o.v_row[eb * o.cache_bstride + (n - 2 * HD)] = rv;
        }
      } else if (P == kUp) {
        o.out[(long long)eb * N + n] = __float2bfloat16(gelu_tanh(round_bf16(v)));
      } else {
        o.out[(long long)eb * N + n] = __float2bfloat16(resid + round_bf16(v));
      }
    }
    __syncthreads();  // red is reused by the next tile
  }
}

template <int D>
__device__ __forceinline__ void attention_tc(const TcArgs& a, int layer, unsigned char* smem,
                                             WRing& r, KVRing& kv) {
  using C = AttnChunk<D>;
  constexpr int TPP = D / 8;             // threads per row: one 16-byte piece each
  constexpr int RPP = kThreads / TPP;    // rows per pass
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HD = a.H * D, rank = kv.rank;

  float* qs = reinterpret_cast<float*>(smem + a.region_off);
  float* knew = qs + D;         // the new K and V rows at pos, when this half holds pos
  float* vnew = knew + D;
  float* xst = vnew + D;        // [0] this half's max, [1] its sum: read by the peer
  float* statm = xst + 8;       // per-warp max
  float* stats = statm + kWarps;  // per-warp sum
  float* opart = stats + kWarps;  // this half's p @ V, f32: read by the peer
  float* part = opart + D;        // [kWarps, D] per-warp partial sums of p @ V
  float* sc = part + kWarps * D;  // this half's scores, then its p
  const bf16* ring = reinterpret_cast<const bf16*>(smem + a.kvring_off);

  const int npf = kv.npf, nck = kv.nck;
  const bool has_new = kv.tb <= a.pos && a.pos < kv.te;
  const int nl = npf + (has_new ? 1 : 0);
  const long long layer_cache = (long long)layer * a.B * a.S * HD;
  const int c = tid % TPP, rr = tid / TPP;

  for (int k = 0; k < kv.items; ++k) {
    const int item = kv.first_item + k * kv.item_stride;
    const int b = item / a.H, h = item % a.H;

    __syncthreads();  // the region is free (previous item, previous phase)
    const long long row_new = layer_cache + (long long)b * a.S * HD + (long long)a.pos * HD + h * D;
    float qd = 0.f, kd = 0.f, vd = 0.f;  // D <= kThreads: one element a thread
    if (tid < D) {
      qd = ld_cg(a.q_buf + b * HD + h * D + tid);
      if (has_new) {
        kd = ld_cg(a.kc + row_new + tid);
        vd = ld_cg(a.vc + row_new + tid);
      }
    }
    // the weight ring's free slots are refilled while those loads are in flight
    refill(a, r);
    if (tid < D) {
      qs[tid] = qd;
      knew[tid] = kd;
      vnew[tid] = vd;
    }
    __syncthreads();

    // scores of this half's positions below pos; TPP lanes share a row
    float qv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[i] = qs[c * 8 + i];
    float mx = -INFINITY;
    for (int j = 0; j < nck; ++j) {
      if (kv.issued == kv.consumed) refill_kv<D>(a, kv);  // a ring shallower than an item
      const int slot = kv.head.slot;
      mbar_wait(kv.bars + slot * 8, kv.head.parity);
      const bf16* rows = ring + slot * (C::kBytes / 2);
      const int nrows = min(C::kRows, npf - j * C::kRows);
#pragma unroll
      for (int r0 = 0; r0 < C::kRows; r0 += RPP) {
        const int r = r0 + rr;
        float dot = 0.f;
        if (r < nrows) {
          float kvv[8];
          unpack_bf16(*reinterpret_cast<const uint4*>(rows + r * C::kPitch + c * 8), kvv);
#pragma unroll
          for (int i = 0; i < 8; ++i) dot += qv[i] * kvv[i];
        }
#pragma unroll
        for (int off = TPP / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (r < nrows) {
          const float s = dot * a.scale;
          if (c == 0) sc[j * C::kRows + r] = s;
          mx = fmaxf(mx, s);
        }
      }
      __syncthreads();
      ++kv.consumed;
      advance(kv.head, 1, kv.slots);
    }
    if (has_new && warp == 0) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qs[d] * knew[d];
      const float s = warp_sum(dot) * a.scale;
      if (lane == 0) sc[npf] = s;
      mx = fmaxf(mx, s);
    }

    // this half's max and sum; the two halves swap them in one cluster
    // barrier and combine them in rank order
    mx = warp_max(mx);
    if (lane == 0) statm[warp] = mx;
    __syncthreads();
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, statm[w]);
    float sum = 0.f;
    for (int t = tid; t < nl; t += kThreads) sum += expf(sc[t] - m);
    sum = warp_sum(sum);
    if (lane == 0) stats[warp] = sum;
    __syncthreads();
    sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += stats[w];
    if (tid == 0) {
      xst[0] = m;
      xst[1] = sum;
    }
    cluster.sync();
    {
      const float* peer = cluster.map_shared_rank(xst, rank ^ 1);
      const float m_peer = peer[0], l_peer = peer[1];
      const float mg = fmaxf(m, m_peer);
      // an empty half has max -inf and sum 0: its term is 0
      const float mine = sum == 0.f ? 0.f : sum * expf(m - mg);
      const float theirs = l_peer == 0.f ? 0.f : l_peer * expf(m_peer - mg);
      sum = rank == 0 ? mine + theirs : theirs + mine;
      m = mg;
    }
    for (int t = tid; t < nl; t += kThreads) sc[t] = round_bf16(expf(sc[t] - m) / sum);
    __syncthreads();

    // p @ V: thread (rr, c) takes piece c of rows rr, rr + RPP, ...
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int j = 0; j < nck; ++j) {
      if (kv.issued == kv.consumed) refill_kv<D>(a, kv);  // a ring shallower than an item
      const int slot = kv.head.slot;
      mbar_wait(kv.bars + slot * 8, kv.head.parity);
      const bf16* rows = ring + slot * (C::kBytes / 2);
      const int nrows = min(C::kRows, npf - j * C::kRows);
      for (int r = rr; r < nrows; r += RPP) {
        float vv[8];
        unpack_bf16(*reinterpret_cast<const uint4*>(rows + r * C::kPitch + c * 8), vv);
        const float p = sc[j * C::kRows + r];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += p * vv[i];
      }
      __syncthreads();
      ++kv.consumed;
      advance(kv.head, 1, kv.slots);
    }
    // the row groups of a warp (lanes TPP apart) by shuffles, then the
    // warps in order: a fixed order either way
#pragma unroll
    for (int off = TPP; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }
    if (lane < TPP) {
#pragma unroll
      for (int i = 0; i < 8; ++i) part[warp * D + c * 8 + i] = acc[i];
    }
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += part[w * D + d];
      if (has_new) o += sc[npf] * vnew[d];
      opart[d] = o;
    }
    bf16* out = a.o_buf + b * HD + h * D;
    cluster.sync();
    // each half writes half of the columns: rank 0's part first
    const float* peer = cluster.map_shared_rank(opart, rank ^ 1);
    for (int d = rank * (D / 2) + tid; d < (rank + 1) * (D / 2); d += kThreads) {
      out[d] = __float2bfloat16(rank == 0 ? opart[d] + peer[d] : peer[d] + opart[d]);
    }
  }
}

__device__ __forceinline__ void stamp(const TcArgs& a, int i) {
  if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0) a.stamps[i] = globaltimer();
}

// The whole step.  Every thread reaches every barrier (grid, block and
// cluster): no thread leaves a loop early.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(TcArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  stamp(a, 0);
  const uint32_t wbars = smem_addr(smem), abars = wbars + kMaxWSlots * 8;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.wslots; ++i) mbar_init(wbars + i * 8, kThreads);
    for (int i = 0; i < a.aslots; ++i) mbar_init(abars + i * 8, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  WRing r;
  r.base = smem_addr(smem + kWRingOff);
  r.bars = wbars;
  r.slots = a.wslots;
  r.pitch = a.kc_cols + 8;
  r.slot_bytes = kTileRows * r.pitch * 2;
  __shared__ PhaseTab tab[4];
  if (threadIdx.x == 0) {
    const bf16* ws[4] = {a.wqkv, a.wproj, a.wup, a.wdown};
    const int ns[4] = {3 * a.E, a.E, a.F, a.E}, ks[4] = {a.E, a.E, a.E, a.F};
    int c0 = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      tab[p].w = ws[p];
      tab[p].n = ns[p];
      tab[p].k = ks[p];
      tab[p].cpt = (ks[p] + a.kc_cols - 1) / a.kc_cols;
      tiles_of(p, c0, a, tab[p]);
      c0 += ns[p] / kTileRows;
    }
  }
  __syncthreads();
  r.tab = tab;
  int per_layer = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) per_layer += tab[p].count * tab[p].cpt;
  r.total = a.L * per_layer;
  r.issued = r.consumed = 0;
  r.head = {0, 0};
  r.i_slot = r.i_layer = r.i_tile = r.i_chunk = r.i_phase = 0;
  first_phase(tab, r.i_phase);
  refill(a, r);
  KVRing kv;
  kv_setup<D>(a, kv, smem_addr(smem + a.kvring_off), abars);
  refill_kv<D>(a, kv);

  int st = 1;
  if (a.stamps) {
    for (int e = 0; e < a.empty_barriers; ++e) {
      grid.sync();
      stamp(a, st++);
    }
  }
  const int HD = a.H * D, E = a.E;
  const long long cache_bstride = (long long)a.S * HD;
#pragma unroll 1
  for (int l = 0; l < a.L; ++l) {
    const float* ln = a.ln + (long long)l * 4 * E;
    const long long row = (long long)l * a.B * a.S * HD + (long long)a.pos * HD;
    // phases 0 LN0 + qkv, 1 attention, 2 proj, 3 LN1 + up, 4 down, each
    // ended by a grid barrier (but the last: the kernel's end orders it)
#pragma unroll 1
    for (int ph = 0; ph < 5; ++ph) {
      if (ph == 1) {
        attention_tc<D>(a, l, smem, r, kv);
      } else {
        const int P = ph == 0 ? kQkv : ph - 1;
        const bf16* xin = P == kProj ? a.o_buf : P == kDown ? a.h_buf : a.x;
        const float* lnp = P == kQkv ? ln : P == kUp ? ln + 2 * E : nullptr;
        const Outs o{a.q_buf, a.kc + row, a.vc + row, cache_bstride,
                     P == kUp ? a.h_buf : a.x};
        gemv_tc<D>(a, r, kv, P, xin, lnp, o, smem);
      }
      if (ph < 4 || l + 1 < a.L || a.stamps) {
        grid.sync();
        stamp(a, st++);
      }
    }
  }
}

// Shared memory of one plan: the fixed part, the two rings and the region
// (the widest gemv input with LayerNorm parameters, or the attention
// phase's vectors, partial sums and scores).
template <int D>
size_t plan_smem(const TcArgs& a, int kc_cols, int wslots, int aslots, int* kvring_off,
                 int* region_off) {
  const size_t wring = (size_t)wslots * kTileRows * (kc_cols + 8) * 2;
  const size_t kvring = (size_t)aslots * AttnChunk<D>::kBytes;
  *kvring_off = (int)(kWRingOff + wring);
  *region_off = (int)(kWRingOff + wring + kvring);
  const size_t x_in = std::max((size_t)a.B * (std::max(a.E, a.F) + 8) * 2,
                               (size_t)a.B * (a.E + 8) * 2 + (size_t)a.E * 8);
  const size_t attn = (size_t)(4 * D + 8 + 2 * kWarps + kWarps * D + a.S) * 4;
  return *region_off + std::max(x_in, attn);
}

struct Plan {
  std::mutex mu;
  int device = -1, B = 0, E = 0, F = 0, S = 0;
  int kc_cols = 0, wslots = 0, aslots = 0, kvring_off = 0, region_off = 0;
  size_t smem = 0;
  int blocks = 0;
};

template <int D>
cudaError_t choose_plan(Plan& pl, const TcArgs& a, int device) {
  int max_smem = 0, sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                         device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  // K/V chunks of one layer and item for a half of the cache
  const int half = (a.S + 1) / 2;
  const int kv_chunks =
      std::max(2, 2 * ((half + AttnChunk<D>::kRows - 1) / AttnChunk<D>::kRows));
  // (weight slots, K/V slots): a layer of K/V ahead first, then the weight
  // ring; then narrower weight chunks (ops/decode_step.py's
  // fused_step_supported admits only shapes that fit the last: 16 columns,
  // one slot each)
  const int a_full = std::min(kMaxASlots, kv_chunks);
  const int prefs[][2] = {{8, a_full}, {6, a_full}, {5, a_full}, {4, a_full}, {4, 8},
                          {4, 4},      {2, 4},      {2, 2},      {1, 2},      {1, 1}};
  const int kmax = std::max(a.E, a.F);  // chunks are a power of 2 wide, <= kChunkCols
  bool found = false;
  int kc0 = 16;
  while (kc0 < std::min(kChunkCols, kmax)) kc0 *= 2;
  for (int kc = kc0; kc >= 16 && !found; kc /= 2) {
    for (const auto& p : prefs) {
      int kv_off = 0, reg_off = 0;
      const size_t need = plan_smem<D>(a, kc, p[0], p[1], &kv_off, &reg_off);
      if (need <= (size_t)max_smem) {
        pl.kc_cols = kc;
        pl.wslots = p[0];
        pl.aslots = p[1];
        pl.kvring_off = kv_off;
        pl.region_off = reg_off;
        pl.smem = need;
        found = true;
        break;
      }
    }
  }
  if (!found) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.smem);
  if (e != cudaSuccess) return e;
  // as many clusters of 2 as are co-resident, at most one block an SM
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(sms);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, decode_kernel<D>, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  pl.blocks = kCluster * std::min(clusters, sms / kCluster);
  pl.device = device;
  pl.B = a.B;
  pl.E = a.E;
  pl.F = a.F;
  pl.S = a.S;
  return cudaSuccess;
}

template <int D>
cudaError_t launch_tc(TcArgs a, cudaStream_t stream) {
  static Plan pl;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(pl.mu);
  if (pl.device != device || pl.B != a.B || pl.E != a.E || pl.F != a.F || pl.S != a.S) {
    e = choose_plan<D>(pl, a, device);
    if (e != cudaSuccess) return e;
  }
  a.kc_cols = pl.kc_cols;
  a.spc_shift = 0;
  while ((16 << a.spc_shift) < a.kc_cols) ++a.spc_shift;
  a.wslots = pl.wslots;
  a.aslots = pl.aslots;
  a.kvring_off = pl.kvring_off;
  a.region_off = pl.region_off;
  void* args[] = {&a};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.gridDim = dim3(pl.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(decode_kernel<D>), args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t dispatch(const TcArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_tc<32>(a, stream);
    case 64: return launch_tc<64>(a, stream);
    case 128: return launch_tc<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" const char* dk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static int decode_step(void* x, const void* ln, const void* wqkv, const void* wproj,
                       const void* wup, const void* wdown, void* kc, void* vc, void* q_buf,
                       void* o_buf, void* h_buf, int L, int B, int E, int H, int D, int F,
                       int S, int pos, int dtype, void* stamps, int empty_barriers,
                       void* stream) {
  if (B < 1 || B > kMaxBatch || pos < 0 || pos >= S || H * D != E) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)D);
  cudaError_t err;
  if (dtype == 0 && stamps == nullptr) {
    StepArgs a{static_cast<float*>(x), static_cast<const float*>(ln),
               static_cast<const float*>(wqkv), static_cast<const float*>(wproj),
               static_cast<const float*>(wup), static_cast<const float*>(wdown),
               static_cast<float*>(kc), static_cast<float*>(vc), static_cast<float*>(q_buf),
               static_cast<float*>(o_buf), static_cast<float*>(h_buf), L, B, E, H, F, S, pos,
               scale};
    err = dispatch_f32(a, D, s);
  } else if (dtype == 1) {
    using tc::bf16;
    tc::TcArgs a{};
    a.x = static_cast<bf16*>(x);
    a.ln = static_cast<const float*>(ln);
    a.wqkv = static_cast<const bf16*>(wqkv);
    a.wproj = static_cast<const bf16*>(wproj);
    a.wup = static_cast<const bf16*>(wup);
    a.wdown = static_cast<const bf16*>(wdown);
    // m16 tiles of rows, 16-deep steps in 32-element pieces
    if (E % 32 || F % 32) return static_cast<int>(cudaErrorInvalidValue);
    a.kc = static_cast<bf16*>(kc);
    a.vc = static_cast<bf16*>(vc);
    a.q_buf = static_cast<bf16*>(q_buf);
    a.o_buf = static_cast<bf16*>(o_buf);
    a.h_buf = static_cast<bf16*>(h_buf);
    a.stamps = static_cast<long long*>(stamps);
    a.empty_barriers = empty_barriers;
    a.L = L;
    a.B = B;
    a.E = E;
    a.H = H;
    a.F = F;
    a.S = S;
    a.pos = pos;
    a.scale = scale;
    err = tc::dispatch(a, D, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// x [B, E] is updated in place to the hidden state after the last layer.
// ln [L, 4, E] f32 (ln0 scale, ln0 bias, ln1 scale, ln1 bias); weights are
// stacked [L, N, K]; caches [L, B, S, H, D]; scratch q/o [B, H*D], h [B, F].
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int dk_decode_step(void* x, const void* ln, const void* wqkv, const void* wproj,
                              const void* wup, const void* wdown, void* kc, void* vc,
                              void* q_buf, void* o_buf, void* h_buf, int L, int B, int E,
                              int H, int D, int F, int S, int pos, int dtype, void* stream) {
  return decode_step(x, ln, wqkv, wproj, wup, wdown, kc, vc, q_buf, o_buf, h_buf, L, B, E, H,
                     D, F, S, pos, dtype, nullptr, 0, stream);
}

// The bf16 step with timestamps: stamps [1 + empty_barriers + 5 L] int64 ns
// (%globaltimer): kernel entry, the end of each of `empty_barriers` grid
// barriers with no work, then the end of each phase (the barrier that
// follows it) of every layer.
extern "C" int dk_decode_step_stamped(void* x, const void* ln, const void* wqkv,
                                      const void* wproj, const void* wup, const void* wdown,
                                      void* kc, void* vc, void* q_buf, void* o_buf,
                                      void* h_buf, int L, int B, int E, int H, int D, int F,
                                      int S, int pos, int dtype, void* stamps,
                                      int empty_barriers, void* stream) {
  if (dtype != 1 || stamps == nullptr || empty_barriers < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return decode_step(x, ln, wqkv, wproj, wup, wdown, kc, vc, q_buf, o_buf, h_buf, L, B, E, H,
                     D, F, S, pos, dtype, stamps, empty_barriers, stream);
}

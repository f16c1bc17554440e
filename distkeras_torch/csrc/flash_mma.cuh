// Warp-level building blocks of the bf16 fused decode step
// (decode_step.cu), in inline PTX for sm_90a:
//   - mma.sync m16n8k16, bf16 operands, f32 accumulators;
//   - ldmatrix (x4, plain and .trans) from shared memory;
//   - cp.async.cg 16-byte (and cp.async.ca 4-byte) copies with
//     commit_group / wait_group, zero-filling rows past the tensor's end;
//   - an XOR-swizzled [rows, D] bf16 tile layout in shared memory, in which
//     the eight 16-byte row pieces that one ldmatrix phase reads (eight
//     rows, one column chunk) fall in eight different bank groups.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), which the kernels rely on:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//                           a2 = (g, 2t + 8..),  a3 = (g + 8, 2t + 8..)
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..)
// so the C fragments of two neighbouring n-blocks, rounded to bf16 and
// packed in pairs, are the A fragment of one 16-deep k-step: the
// re-packing that keeps P (and dS) in registers between two products.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronous (the per-row f32 statistics)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i of every lane receives its share of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a * b on the tensor cores: 16 x 8 f32 += (16 x 16 bf16) (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// e^x through ex2: exactly 0 at x = -inf
__device__ __forceinline__ float exp_approx(float x) { return exp2_approx(x * kLog2e); }

// A tile of rows x COLS bf16 in shared memory, COLS / 8 chunks of 16 bytes
// per row.  Chunk c of row r is stored at chunk c ^ f(r): rows that share a
// 128-byte line span get different XOR keys, so the eight rows one ldmatrix
// phase reads at one logical chunk land on eight distinct 16-byte bank groups.
template <int COLS>
struct Swizzle {
  static constexpr int kChunks = COLS / 8;
  static constexpr int kKeys = kChunks < 8 ? kChunks : 8;   // XOR keys in use
  static constexpr int kRowsPerKey = 8 / kKeys;              // rows sharing a line
  static_assert(kChunks >= 4 && (kChunks & (kChunks - 1)) == 0, "COLS in {32, 64, 128, ...}");

  // byte offset of chunk c of row r
  __device__ __forceinline__ static uint32_t chunk(int r, int c) {
    return static_cast<uint32_t>((r * kChunks + (c ^ ((r / kRowsPerKey) & (kKeys - 1)))) * 16);
  }
  // byte offset of element (r, col); col even for a 4-byte pair
  __device__ __forceinline__ static uint32_t elem(int r, int col) {
    return chunk(r, col >> 3) + static_cast<uint32_t>((col & 7) * 2);
  }
};

// Rows [0, n) of a strided [rows, COLS] bf16 block (rows `row_stride`
// elements apart, each 16-byte aligned) into a swizzled ROWS x COLS tile at
// `dst`, asynchronously; rows n..ROWS-1 become zeros.  Needs n >= 1.
template <int COLS, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                long long row_stride, int n, int tid) {
  constexpr int C = COLS / 8;
#pragma unroll
  for (int i = tid; i < ROWS * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const bool ok = r < n;
    cp_async16(dst + Swizzle<COLS>::chunk(r, c), src + (ok ? r : 0) * row_stride + c * 8,
               ok ? 16 : 0);
  }
}

}  // namespace flash_mma

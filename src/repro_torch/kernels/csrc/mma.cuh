// Tensor-core MMA wrappers shared by the matrix-engine kernels.
//
// Fragment layouts (PTX ISA, warp-level mma.sync), with g = lane >> 2 and
// t = lane & 3:
//
//   m8n8k4 f64 (DMMA):  A[g][t]            one double per thread
//                       B[t][g]            one double per thread
//                       C/D[g][2t + i]     two doubles per thread, i = 0, 1
//
//   m16n8k16 bf16 -> f32 (HMMA):
//                       A regs: (g, 2t..2t+1), (g+8, 2t..2t+1),
//                               (g, 2t+8..2t+9), (g+8, 2t+8..2t+9)
//                       B regs: (2t..2t+1, g), (2t+8..2t+9, g)
//                       C/D:    (g, 2t..2t+1), (g+8, 2t..2t+1)
//
// In a 32-bit register holding two bf16 values the lower half holds the
// element with the lower index.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// D = A * B + C on the FP64 tensor cores (8x8x4).
__device__ __forceinline__ void dmma_884(double& d0, double& d1, double a,
                                         double b, double c0, double c1) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%4, %5};\n"
      : "=d"(d0), "=d"(d1)
      : "d"(a), "d"(b), "d"(c0), "d"(c1));
}

// D = A * B + C on the bf16 tensor cores with a float32 accumulator.
__device__ __forceinline__ void hmma_16816_bf16(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1,
                                                const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t float_to_bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// 16-byte global -> shared copy that bypasses registers (cp.async, L2
// only), and its group bookkeeping: commit the copies issued so far as one
// group; wait until at most N groups are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
// The same copy, writing 16 zero bytes instead when `read` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 16 : 0)
               : "memory");
}
// 4-byte copy, for rows that are not 16-byte aligned; writes zero instead
// when `read` is false (the 4-byte form has no L2-only variant).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lane i gives the address of row
// i % 8 of matrix i / 8; register j gets matrix j's row g, elements 2t and
// 2t+1 (.trans: its elements (2t, g) and (2t+1, g)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

#define REPRO_ERROR_STRING(prefix)                                   \
  extern "C" const char* prefix##_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));       \
  }

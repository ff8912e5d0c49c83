// K4: the quotient's constraint terms over the rows of one sub-coset.
//
// Replaces no TPU kernel: the reference evaluates protocol.constraint_terms
// with its compiler fusing the eager field ops; the port ran them eagerly,
// one int64 torch op at a time (at k=20 ~17,000 launches a sub-coset, and
// ~5 GB of traffic for each modular add).  This kernel runs the term program
// of backend/term_program.py (the terms lowered once per proving key) for
// one row per thread: every term in canonical order, each folded into the
// accumulator as it is made (acc = acc * y + term), then the Z_H division,
// and writes one canonical Montgomery element a row.
//
// What bounds it on an H100: the 32-bit multiplier (a Montgomery product
// is ~136 multiply-adds; the AES cell's program has ~400 a row against
// ~440 64-byte loads, most of them hits in L1 or L2).  Design: the program
// is an interpreter's instruction list read by every thread alike (one
// uniform 16-byte load an instruction, prefetched one ahead), so its
// branches never diverge and the code stays small in the instruction
// cache whatever the circuit; a row's values live in a few slots of
// shared memory, laid out slot-major and thread-minor so that a warp's
// 16-byte accesses are conflict free; the launch's constant table
// (challenges, delta^i * shift, the program's constants) is copied into
// shared memory once a block.  A rotation is index arithmetic
// (row + r) mod n on the stacks; nothing is copied or widened.
#include "field.cuh"

namespace {

enum : int {
  OP_LOAD = 0, OP_OMEGA = 1, OP_ADD = 2, OP_SUB = 3, OP_MUL = 4, OP_NEG = 5,
  OP_FIRST = 6, OP_FOLD = 7
};
constexpr int TABLE_Y = 0;
constexpr int TABLE_ZH_INV = 1;

__device__ __forceinline__ void from_u4(uint32_t x[8], uint4 lo, uint4 hi) {
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// operand a: slot a of this thread where a >= 0, else table row ~a
__device__ __forceinline__ void get(uint32_t x[8], int a, const uint4* table,
                                    const uint4* slots, int threads, int tid) {
  if (a >= 0) {
    from_u4(x, slots[(2 * a) * threads + tid], slots[(2 * a + 1) * threads + tid]);
  } else {
    from_u4(x, table[2 * ~a], table[2 * ~a + 1]);
  }
}

__device__ __forceinline__ void put(uint4* slots, int d, int threads, int tid,
                                    const uint32_t x[8]) {
  slots[(2 * d) * threads + tid] = make_uint4(x[0], x[1], x[2], x[3]);
  slots[(2 * d + 1) * threads + tid] = make_uint4(x[4], x[5], x[6], x[7]);
}

}  // namespace

__global__ void quotient_terms_kernel(
    int32_t* __restrict__ out, const int32_t* __restrict__ stat,
    const int32_t* __restrict__ dyn, const int32_t* __restrict__ omega,
    const int4* __restrict__ code, int n_code,
    const int32_t* __restrict__ table_limbs, int n_table, int64_t n_static,
    int64_t n, int64_t row0, int64_t rows, Modulus m) {
  extern __shared__ uint4 smem[];
  uint4* table = smem;                  // n_table elements, 2 uint4 each
  uint4* slots = smem + 2 * n_table;    // slot-major, then thread
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  for (int c = tid; c < n_table; c += threads) {
    uint32_t w[8];
    fe_load(table_limbs + (int64_t)c * 16, w);
    table[2 * c] = make_uint4(w[0], w[1], w[2], w[3]);
    table[2 * c + 1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * threads + tid;
  if (i >= rows) return;
  const int64_t row = row0 + i;
  const int64_t mask = n - 1;

  uint32_t acc[8], x[8], y[8], r[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) acc[w] = 0;
  int4 next = __ldg(code);
  for (int j = 0; j < n_code; ++j) {
    const int4 ins = next;
    if (j + 1 < n_code) next = __ldg(code + j + 1);
    switch (ins.x) {
      case OP_LOAD: {
        const int64_t p = ins.z;
        const int32_t* src = p < n_static ? stat + p * n * 16
                                          : dyn + (p - n_static) * n * 16;
        fe_load(src + ((row + ins.w) & mask) * 16, r);
        put(slots, ins.y, threads, tid, r);
        break;
      }
      case OP_OMEGA:
        fe_load(omega + row * 16, r);
        put(slots, ins.y, threads, tid, r);
        break;
      case OP_ADD:
        get(x, ins.z, table, slots, threads, tid);
        get(y, ins.w, table, slots, threads, tid);
        fe_add(r, x, y, m);
        put(slots, ins.y, threads, tid, r);
        break;
      case OP_SUB:
        get(x, ins.z, table, slots, threads, tid);
        get(y, ins.w, table, slots, threads, tid);
        fe_sub(r, x, y, m);
        put(slots, ins.y, threads, tid, r);
        break;
      case OP_MUL:
        get(x, ins.z, table, slots, threads, tid);
        get(y, ins.w, table, slots, threads, tid);
        fe_mont_mul(r, x, y, m);
        put(slots, ins.y, threads, tid, r);
        break;
      case OP_NEG:
#pragma unroll
        for (int w = 0; w < 8; ++w) y[w] = 0;
        get(x, ins.z, table, slots, threads, tid);
        fe_sub(r, y, x, m);
        put(slots, ins.y, threads, tid, r);
        break;
      case OP_FIRST:
        get(acc, ins.z, table, slots, threads, tid);
        break;
      case OP_FOLD:
        get(y, ~TABLE_Y, table, slots, threads, tid);
        fe_mont_mul(r, acc, y, m);
        get(x, ins.z, table, slots, threads, tid);
        fe_add(acc, r, x, m);
        break;
    }
  }
  get(y, ~TABLE_ZH_INV, table, slots, threads, tid);
  fe_mont_mul(r, acc, y, m);
  fe_store(out + i * 16, r);
}

extern "C" int quotient_terms_launch(
    void* out, const void* stat, const void* dyn, const void* omega,
    const void* code, int n_code, const void* table, int n_table,
    int64_t n_static, int64_t n, int64_t row0, int64_t rows, int slots,
    int threads, const uint32_t* p, uint32_t n0, void* stream) {
  Modulus m = make_modulus(p, n0);
  const size_t smem = (size_t)(n_table + (size_t)slots * threads) * 32;
  cudaError_t err = cudaFuncSetAttribute(
      quotient_terms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (rows + threads - 1) / threads;
  quotient_terms_kernel<<<(unsigned)blocks, threads, smem,
                          (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)stat, (const int32_t*)dyn,
      (const int32_t*)omega, (const int4*)code, n_code,
      (const int32_t*)table, n_table, n_static, n, row0, rows, m);
  return (int)cudaGetLastError();
}

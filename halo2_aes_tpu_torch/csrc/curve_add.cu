// K3: complete projective point arithmetic on BN254 G1 (y^2 = x^3 + 3).
//
// Replaces the Pallas kernel of halo2_aes_tpu/ops/pallas_curve.py
// (_make_kernel, _fn): Renes-Costello-Batina 2015/1060 algorithm 7
// (addition) and algorithm 9 (doubling) for a = 0, b3 = 3 * b = 9, in the
// operation order of the plain versions, so projective limbs are
// bit-identical.  The formulas are complete: no branch on identity,
// doubling or negation.
//
// What bounds it on an H100: one addition is 12 Montgomery products
// (~1,540 32-bit multiply-adds) against 576 bytes of int32-limb traffic:
// the integer multiplier binds, about 2:1 over memory.  Alone the adder
// was never the MSM's cost; what its first interface (six equal-shape
// contiguous tensors) forced around it was: slice copies, materialised
// identities, gathers, selects, and one launch per tree level.  So the
// entries here are the shapes the MSM needs:
//  - curve_add: each operand is read in place at row
//    off + (r / inner) * outer + r % inner with r = i % rows, so the two
//    halves of a (G, m) level, a leading slice or one broadcast point need
//    no copy;
//  - curve_fold2: two levels of the pairing tree (node i with i + m/2) in
//    one launch: a thread reads the four leaves i + t*m/4, adds them in
//    registers and writes the two level-1 nodes and the level-2 node (the
//    Fenwick extraction reads every level); a leaf is read once, not twice;
//  - curve_add_masked: q is gathered by an int64 row index and replaced by
//    the identity (0, 1, 0) where its mask byte is clear: one Fenwick
//    level a launch;
//  - curve_double: `times` doublings of each point in registers.
// One thread per output row, 128 threads a block.  ptxas (nvcc 12.8,
// sm_90a), registers with no spills: curve_add 108, curve_fold2 178,
// curve_add_masked 104, curve_double 80.  At 2^19 pairs the adder runs
// ~4.3e12 wide multiply-adds a second, about half of the card's nominal
// 32-bit rate if a wide multiply-add takes two dispatch slots.
#include "curve.cuh"

// Three coordinate tensors read in place: row r of the operand is at
// off + (r / inner) * outer + r % inner, r = i % rows
struct Operand {
  const int32_t *x, *y, *z;
  int64_t rows, inner, outer;
};

__device__ __forceinline__ int64_t operand_row(const Operand& o, int64_t i) {
  const int64_t r = o.rows == 1 ? 0 : i % o.rows;
  return o.inner >= o.rows ? r : (r / o.inner) * o.outer + r % o.inner;
}

__global__ void __launch_bounds__(128)
curve_add_kernel(int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                 int32_t* __restrict__ z3, Operand a, Operand b, int64_t n,
                 Modulus m) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p, q;
  pt_load(p, a.x, a.y, a.z, operand_row(a, i));
  pt_load(q, b.x, b.y, b.z, operand_row(b, i));
  pt_add(p, p, q, m);
  pt_store(x3, y3, z3, i, p);
}

// Level 0 is (G, m) rows; out1 is level 1 (G, m/2), out2 level 2 (G, m/4);
// thread i of group g folds the leaves i + t * m/4.
__global__ void __launch_bounds__(128)
curve_fold2_kernel(int32_t* __restrict__ x1, int32_t* __restrict__ y1,
                   int32_t* __restrict__ z1, int32_t* __restrict__ x2,
                   int32_t* __restrict__ y2, int32_t* __restrict__ z2,
                   const int32_t* __restrict__ x0,
                   const int32_t* __restrict__ y0,
                   const int32_t* __restrict__ z0, int64_t groups, int64_t mq,
                   Modulus m) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= groups * mq) return;
  const int64_t g = t / mq, i = t % mq;
  const int64_t leaf = g * 4 * mq + i;
  const int64_t node1 = g * 2 * mq + i;
  // one adder body run three times (three inlined copies overflow the
  // instruction cache): leaves 0 + 2, leaves 1 + 3, then the two sums
  Pt s0, a, b;
#pragma unroll 1
  for (int step = 0; step < 3; ++step) {
    if (step < 2) {
      pt_load(a, x0, y0, z0, leaf + step * mq);
      pt_load(b, x0, y0, z0, leaf + (step + 2) * mq);
    } else {
      b = s0;  // a still holds the second level-1 node; p + q is symmetric
    }
    pt_add(a, a, b, m);
    if (step == 0) {
      pt_store(x1, y1, z1, node1, a);
      s0 = a;
    } else if (step == 1) {
      pt_store(x1, y1, z1, node1 + mq, a);
    } else {
      pt_store(x2, y2, z2, t, a);
    }
  }
}

__global__ void __launch_bounds__(128)
curve_add_masked_kernel(int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                        int32_t* __restrict__ z3, Operand a,
                        const int32_t* __restrict__ qx,
                        const int32_t* __restrict__ qy,
                        const int32_t* __restrict__ qz,
                        const int64_t* __restrict__ index,
                        const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ one, int64_t n, Modulus m) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p, q;
  pt_load(p, a.x, a.y, a.z, operand_row(a, i));
  if (mask[i]) {
    pt_load(q, qx, qy, qz, index[i]);
  } else {
    fe_load(one, q.y);
#pragma unroll
    for (int w = 0; w < 8; ++w) q.x[w] = q.z[w] = 0;
  }
  pt_add(p, p, q, m);
  pt_store(x3, y3, z3, i, p);
}

__global__ void __launch_bounds__(128)
curve_double_kernel(int32_t* __restrict__ x3, int32_t* __restrict__ y3,
                    int32_t* __restrict__ z3, const int32_t* __restrict__ x,
                    const int32_t* __restrict__ y,
                    const int32_t* __restrict__ z, int64_t n, int times,
                    Modulus m) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p;
  pt_load(p, x, y, z, i);
  for (int t = 0; t < times; ++t) pt_double(p, m);
  pt_store(x3, y3, z3, i, p);
}

static unsigned blocks_for(int64_t n) { return (unsigned)((n + 127) / 128); }

static bool operand_ok(const Operand& o) {
  return o.rows >= 1 && o.inner >= 1 && o.outer >= 0;
}

// operands as 3 pointers and (rows, inner, outer) each
extern "C" int curve_add_launch(void* x3, void* y3, void* z3, const void* x1,
                                const void* y1, const void* z1, int64_t rows1,
                                int64_t inner1, int64_t outer1, const void* x2,
                                const void* y2, const void* z2, int64_t rows2,
                                int64_t inner2, int64_t outer2, int64_t n,
                                const uint32_t* p, uint32_t n0, void* stream) {
  Operand a = {(const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1,
               rows1, inner1, outer1};
  Operand b = {(const int32_t*)x2, (const int32_t*)y2, (const int32_t*)z2,
               rows2, inner2, outer2};
  if (n < 1 || !operand_ok(a) || !operand_ok(b)) return (int)cudaErrorInvalidValue;
  curve_add_kernel<<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
      (int32_t*)x3, (int32_t*)y3, (int32_t*)z3, a, b, n, make_modulus(p, n0));
  return (int)cudaGetLastError();
}

extern "C" int curve_fold2_launch(void* x1, void* y1, void* z1, void* x2,
                                  void* y2, void* z2, const void* x0,
                                  const void* y0, const void* z0,
                                  int64_t groups, int64_t m, const uint32_t* p,
                                  uint32_t n0, void* stream) {
  if (groups < 1 || m < 4 || m % 4) return (int)cudaErrorInvalidValue;
  curve_fold2_kernel<<<blocks_for(groups * (m / 4)), 128, 0,
                       (cudaStream_t)stream>>>(
      (int32_t*)x1, (int32_t*)y1, (int32_t*)z1, (int32_t*)x2, (int32_t*)y2,
      (int32_t*)z2, (const int32_t*)x0, (const int32_t*)y0, (const int32_t*)z0,
      groups, m / 4, make_modulus(p, n0));
  return (int)cudaGetLastError();
}

extern "C" int curve_add_masked_launch(
    void* x3, void* y3, void* z3, const void* x1, const void* y1,
    const void* z1, int64_t rows1, const void* qx, const void* qy,
    const void* qz, const void* index, const void* mask, const void* one,
    int64_t n, const uint32_t* p, uint32_t n0, void* stream) {
  Operand a = {(const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1,
               rows1, rows1, 0};
  if (n < 1 || rows1 < 1) return (int)cudaErrorInvalidValue;
  curve_add_masked_kernel<<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
      (int32_t*)x3, (int32_t*)y3, (int32_t*)z3, a, (const int32_t*)qx,
      (const int32_t*)qy, (const int32_t*)qz, (const int64_t*)index,
      (const uint8_t*)mask, (const int32_t*)one, n, make_modulus(p, n0));
  return (int)cudaGetLastError();
}

extern "C" int curve_double_launch(void* x3, void* y3, void* z3, const void* x,
                                   const void* y, const void* z, int64_t n,
                                   int times, const uint32_t* p, uint32_t n0,
                                   void* stream) {
  if (n < 1 || times < 0) return (int)cudaErrorInvalidValue;
  curve_double_kernel<<<blocks_for(n), 128, 0, (cudaStream_t)stream>>>(
      (int32_t*)x3, (int32_t*)y3, (int32_t*)z3, (const int32_t*)x,
      (const int32_t*)y, (const int32_t*)z, n, times, make_modulus(p, n0));
  return (int)cudaGetLastError();
}

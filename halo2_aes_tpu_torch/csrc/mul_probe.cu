// P1: integer multiply throughput probe.
//
// Replaces the Pallas kernel of scripts/mul_throughput_probe.py (_fn,
// body _mk_kernel).  For every element e of (16, n) limb-major uint32
// planes a and b (optionally both masked to 16 bits first):
//
//   out[e] = sum over t < K of a[t % 16][e] * b[(t / 16) % 16][e]  (mod 2^32)
//
// accumulated, as the Pallas body does, into 33 accumulators indexed by
// i + j (the CIOS lattice), and written to all 16 output rows.  One
// thread per element; each limb plane is read coalesced (consecutive
// threads, consecutive words).
//
// What bounds it on an H100: 3 x 64 bytes of planes per element against
// K multiply-adds.  At K = 64 the memory traffic dominates; at K = 512
// the products' pairs (i, j) repeat with period 256, so the compiler may
// fold the repeats (the function does not change, but fewer multiplies
// are issued than the K the probe reports).  The probe script counts the
// IMAD instructions actually compiled (cuobjdump -sass) for that reason.
#include <cstdint>
#include <cuda_runtime.h>

template <int K, bool MASK16>
__global__ void mul_probe_kernel(uint32_t* __restrict__ out,
                                 const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b, int64_t n) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t x[16], y[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = a[i * n + e];
    y[i] = b[i * n + e];
    if (MASK16) {
      x[i] &= 0xFFFFu;
      y[i] &= 0xFFFFu;
    }
  }
  uint32_t acc[33];
#pragma unroll
  for (int c = 0; c < 33; ++c) acc[c] = 0;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int i = t % 16, j = (t / 16) % 16;
    acc[(i + j) % 33] += x[i] * y[j];
  }
  uint32_t s = acc[0];
#pragma unroll
  for (int c = 1; c < 33; ++c) s += acc[c];
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i * n + e] = s;
}

template <int K, bool MASK16>
static int launch(void* out, const void* a, const void* b, int64_t n,
                  cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  mul_probe_kernel<K, MASK16><<<(unsigned)blocks, threads, 0, stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n);
  return (int)cudaGetLastError();
}

// k in {64, 512} (the TPU probe's cases); any other k returns
// cudaErrorInvalidValue
extern "C" int mul_probe_launch(void* out, const void* a, const void* b,
                                int64_t n, int k, int mask16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k * 2 + (mask16 ? 1 : 0)) {
    case 128: return launch<64, false>(out, a, b, n, s);
    case 129: return launch<64, true>(out, a, b, n, s);
    case 1024: return launch<512, false>(out, a, b, n, s);
    case 1025: return launch<512, true>(out, a, b, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

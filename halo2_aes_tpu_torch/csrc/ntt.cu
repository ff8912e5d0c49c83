// K2: one pass of the batched four-step NTT over Fr.
//
// Replaces the Pallas kernel of halo2_aes_tpu/ops/pallas_ntt.py (_pass_fn,
// _make_kernel, _stages): every row of length T = 2^lt <= 2048 runs all
// lt radix-2 decimation-in-frequency stages in shared memory, output in
// bit-reversed order.  Stage s (h = T >> (s + 1)) maps the pair
// (u, v) = (x[lo], x[lo + h]) to (u + v, (u - v) * tw), with tw read from
// the host-built stage table of the reference (_stage_tables: limb l of
// stage s at row s * 16 + l, one column per lane; lower-half lanes hold
// Montgomery ONE and need no multiply).
//
// One block per row; the row lives in shared memory word-major
// ([8][T] u32, 32 B per element, 64 KB at T = 2048), so neighbouring
// threads touch neighbouring banks.
#include "field.cuh"

__global__ void ntt_pass_kernel(int32_t* __restrict__ out,
                                const int32_t* __restrict__ x,
                                const int32_t* __restrict__ tw, int lt,
                                Modulus m) {
  extern __shared__ uint32_t sm[];
  const int T = 1 << lt;
  const int64_t base = (int64_t)blockIdx.x * T * 16;
  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    uint32_t v[8];
    fe_load(x + base + (int64_t)e * 16, v);
#pragma unroll
    for (int w = 0; w < 8; ++w) sm[w * T + e] = v[w];
  }
  __syncthreads();
  for (int s = 0; s < lt; ++s) {
    const int hbits = lt - s - 1;
    const int h = 1 << hbits;
    const int32_t* tws = tw + (int64_t)s * 16 * T;
    for (int idx = threadIdx.x; idx < T / 2; idx += blockDim.x) {
      const int j = idx & (h - 1);
      const int lo = ((idx >> hbits) << (hbits + 1)) + j;
      const int hi = lo + h;
      uint32_t u[8], v[8], a[8], d[8], t[8], r[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        u[w] = sm[w * T + lo];
        v[w] = sm[w * T + hi];
        t[w] = ((uint32_t)tws[(2 * w) * T + hi] & 0xFFFFu) |
               ((uint32_t)tws[(2 * w + 1) * T + hi] << 16);
      }
      fe_add(a, u, v, m);
      fe_sub(d, u, v, m);
      fe_mont_mul(r, d, t, m);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        sm[w * T + lo] = a[w];
        sm[w * T + hi] = r[w];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    uint32_t v[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) v[w] = sm[w * T + e];
    fe_store(out + base + (int64_t)e * 16, v);
  }
}

extern "C" int ntt_pass_launch(void* out, const void* x, const void* tw,
                               int64_t rows, int lt, const uint32_t* p,
                               uint32_t n0, void* stream) {
  if (lt < 1 || lt > 11) return (int)cudaErrorInvalidValue;
  Modulus m = make_modulus(p, n0);
  const int T = 1 << lt;
  const size_t smem = (size_t)T * 8 * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = T / 2 < 256 ? T / 2 : 256;
  ntt_pass_kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, (const int32_t*)tw, lt, m);
  return (int)cudaGetLastError();
}

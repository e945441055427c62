// Affine-coupling apply + logdet reduction (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpuflow/kernels/coupling_pallas.py::_kernel
// (pallas_call at :85). Rows are the flattened (B, D) view of x, raw and t
// (D = H*W*C of the transformed half). With log s = log_sigmoid(raw + 2):
//
//   forward: y = (x + t) * exp(log s),   ld = sum_D log s
//   reverse: y = x * exp(-log s) - t,    ld = sum_D log s  (the caller negates)
//
// Bound: bytes. Every element reads three floats and writes one (16 B) for
// a handful of flops, far below the card's ~20 flops per byte of float32
// CUDA-core rate over HBM bandwidth, so the least time is 16*B*D + 4*B bytes
// over 3.35 TB/s.
//
// Design: one block per row. Its threads stride over the row (neighbouring
// threads on neighbouring addresses), each keeping a partial sum of log s in
// a fixed order; the block then reduces the partials in a fixed shared-memory
// tree. So the same inputs give a bit-identical ld, with no atomics and no
// second pass. log_sigmoid is taken in its stable form
// min(z, 0) - log1p(exp(-|z|)), the form PyTorch's and JAX's plain versions
// use; the build leaves out -use_fast_math so expf and log1pf stay accurate.
// Any D is taken (odd D, no padding). Known limit: one block per row gives
// only B blocks (64 at the flagship shape) on the card's 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
coupling_apply_kernel(const float* __restrict__ x, const float* __restrict__ raw,
                      const float* __restrict__ t, float* __restrict__ y,
                      float* __restrict__ ld, long long d) {
  const long long row = blockIdx.x;
  const float* xr = x + row * d;
  const float* rr = raw + row * d;
  const float* tr = t + row * d;
  float* yr = y + row * d;

  float partial = 0.0f;
  for (long long i = threadIdx.x; i < d; i += kThreads) {
    const float z = rr[i] + 2.0f;
    const float log_s = fminf(z, 0.0f) - log1pf(expf(-fabsf(z)));
    if (kReverse) {
      yr[i] = xr[i] * expf(-log_s) - tr[i];
    } else {
      yr[i] = (xr[i] + tr[i]) * expf(log_s);
    }
    partial += log_s;
  }

  __shared__ float sums[kThreads];
  sums[threadIdx.x] = partial;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) sums[threadIdx.x] += sums[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) ld[row] = sums[0];
}

}  // namespace

// C entry point: launches on `stream` and returns cudaGetLastError() (0 on
// success). x, raw, t, y are (rows, d) row-major float32; ld is (rows,).
extern "C" int tpf_coupling_apply(const float* x, const float* raw, const float* t,
                                  float* y, float* ld, long long rows, long long d,
                                  int reverse, void* stream) {
  if (rows <= 0) return 0;
  if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reverse) {
    coupling_apply_kernel<true><<<grid, kThreads, 0, s>>>(x, raw, t, y, ld, d);
  } else {
    coupling_apply_kernel<false><<<grid, kThreads, 0, s>>>(x, raw, t, y, ld, d);
  }
  return static_cast<int>(cudaGetLastError());
}

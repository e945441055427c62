// Fused affine coupling (forward and reverse) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel tpuflow/kernels/coupling_fused.py::_kernel
// (launched by _fused_pallas, entry fused_coupling). It computes the whole
// affine coupling of one GlowStep:
//   h0  = relu(conv3x3(xb) + b0 + h0c)                      (conv_in)
//   for j = 0..L: joint_j = conv3x3(feat_j) (+ bj0 for j = 0); its column
//       blocks add into the targets j..L; target t < L is complete after
//       source t and feeds feat_{t+1} = relu(target t)
//   (raw, t) = target L;  log_s = log_sigmoid(raw + 2)
//   forward: ya = (xa + t) * exp(log_s),   ld =  sum log_s
//   reverse: ya = xa * exp(-log_s) - t,    ld = -sum log_s
//   y = [ya, xb]
// Every product of net-dtype operands accumulates in float32, as the TPU
// kernel's matmuls do; relu features are stored in the net dtype.
//
// What bounds it on this card: operations. At the rollout's shapes a
// launch does 104k-166k MACs per pixel against ~0.5 KB of HBM traffic per
// pixel, far above the H100's ~295 FLOP/byte ridge. This first version is
// simple rather than fast: direct 3x3 convs on the CUDA cores in f32 FMA
// (no tensor cores), one launch per layer, intermediates in device memory
// (scale 0 at 64 members: ~90 MB in f32). A conv block stages its input
// rows plus a 1-pixel zero border in shared memory as f32 copies of
// values rounded to the net dtype, so the products are those of net-dtype
// operands, accumulated in f32. Keeping the chain on chip needs
// space tiling with a 5-pixel halo (one member's padded bf16 plane at
// scale 0 is ~281 KiB, over the 227 KB a block may use) and wgmma; that is
// later work.
//
// Layout: NHWC, contiguous. Packed weights are (9*Cin, Cout) in the net
// dtype, rows ordered (dy, dx, cin) (HWIO reshaped); biases are float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;  // one output pixel per thread
constexpr int kCoTile = 16;    // output channels per thread (registers)
constexpr int kCiTile = 16;    // input channels staged per pass
constexpr int kMaxTile = 576;  // (th+2)*(W+2) cap: keeps smem under 48 KB

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// A value of the input type rounded to the net dtype, as float.
template <typename TIn, typename T>
__device__ __forceinline__ float as_net(TIn v) {
  return to_f32<T>(from_f32<T>(to_f32<TIn>(v)));
}

// relu that keeps NaN, like jnp.maximum(x, 0) and torch.relu.
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

enum Mode { kConvIn = 0, kJoint = 1 };

// 3x3 SAME conv of one member's row tile, kCoTile output channels per
// block column. Grid: (row tiles, ceil(cout / kCoTile), B).
//   kConvIn: v = conv + bias + h0c (h0c batch 1 broadcasts, may be null);
//            feat_out[:, co] = relu(v) in the net dtype (relu_cols = cout).
//   kJoint:  v = first ? conv + bias : acc + conv at global column
//            acc_off + co; columns co < relu_cols finish the current growth
//            target and go to feat_out as relu(v); the rest stay in acc.
template <typename TIn, typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const TIn* __restrict__ in, int cin, const T* __restrict__ wgt,
               int cout, int H, int W, int th, const float* __restrict__ bias,
               const T* __restrict__ h0c, int h0c_batch,
               T* __restrict__ feat_out, int relu_cols,
               float* __restrict__ acc, int acc_stride, int acc_off,
               int first) {
  extern __shared__ float smem[];
  const int tw = W + 2;
  const int tile = (th + 2) * tw;
  float* s_in = smem;                   // [kCiTile][th+2][W+2]
  float* s_w = smem + kCiTile * tile;   // [kCiTile][9][kCoTile]

  const int b = blockIdx.z;
  const int r0 = blockIdx.x * th;
  const int co0 = blockIdx.y * kCoTile;
  const int p = threadIdx.x;
  const int pr = p / W, pc = p % W;
  const bool active = p < th * W && r0 + pr < H;

  float a[kCoTile];
#pragma unroll
  for (int k = 0; k < kCoTile; ++k) a[k] = 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += kCiTile) {
    // Stage the input rows r0-1 .. r0+th plus a zero border.
    for (int i = threadIdx.x; i < kCiTile * tile; i += blockDim.x) {
      const int ci = i % kCiTile, pix = i / kCiTile;
      const int gr = r0 - 1 + pix / tw, gc = pix % tw - 1, gci = ci0 + ci;
      float v = 0.f;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W && gci < cin)
        v = as_net<TIn, T>(in[(((size_t)b * H + gr) * W + gc) * cin + gci]);
      s_in[ci * tile + pix] = v;
    }
    // Stage this block's weight columns for the channel chunk.
    for (int i = threadIdx.x; i < kCiTile * 9 * kCoTile; i += blockDim.x) {
      const int k = i % kCoTile, tap = (i / kCoTile) % 9, ci = i / (9 * kCoTile);
      const int gci = ci0 + ci, co = co0 + k;
      float v = 0.f;
      if (gci < cin && co < cout)
        v = to_f32<T>(wgt[((size_t)tap * cin + gci) * cout + co]);
      s_w[i] = v;
    }
    __syncthreads();
    if (active) {
      const int nci = min(kCiTile, cin - ci0);
      for (int ci = 0; ci < nci; ++ci) {
        const float* si = s_in + ci * tile + pr * tw + pc;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float v = si[(tap / 3) * tw + tap % 3];
          const float4* w4 =
              reinterpret_cast<const float4*>(s_w + (ci * 9 + tap) * kCoTile);
#pragma unroll
          for (int q = 0; q < kCoTile / 4; ++q) {
            const float4 w = w4[q];
            a[4 * q + 0] = fmaf(v, w.x, a[4 * q + 0]);
            a[4 * q + 1] = fmaf(v, w.y, a[4 * q + 1]);
            a[4 * q + 2] = fmaf(v, w.z, a[4 * q + 2]);
            a[4 * q + 3] = fmaf(v, w.w, a[4 * q + 3]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;

  const size_t plane = (size_t)(r0 + pr) * W + pc;
  const size_t pix = (size_t)b * H * W + plane;
#pragma unroll
  for (int k = 0; k < kCoTile; ++k) {
    const int co = co0 + k;
    if (co >= cout) break;
    float v = a[k];
    if (MODE == kConvIn) {
      v += bias[co];
      if (h0c != nullptr) {
        const size_t hb = h0c_batch == 1 ? 0 : (size_t)b;
        v += to_f32<T>(h0c[(hb * H * W + plane) * cout + co]);
      }
      feat_out[pix * cout + co] = from_f32<T>(relu(v));
    } else {
      float* dst = acc + pix * acc_stride + acc_off + co;
      v = first ? v + bias[co] : *dst + v;
      if (co < relu_cols)
        feat_out[pix * relu_cols + co] = from_f32<T>(relu(v));
      else
        *dst = v;
    }
  }
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return x < 0.f ? x - log1pf(expf(x)) : -log1pf(expf(-x));
}

// Affine apply + logdet, one block per member. The logdet is a fixed-order
// in-block reduction (no atomics), so it is deterministic.
__global__ void __launch_bounds__(kThreads)
affine_logdet_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                     const float* __restrict__ acc, int acc_stride,
                     int head_off, float* __restrict__ y,
                     float* __restrict__ ld, int hw, int ca, int cb,
                     int reverse) {
  __shared__ float red[kThreads];
  const int b = blockIdx.x;
  const int c_all = ca + cb;
  float part = 0.f;
  for (int i = threadIdx.x; i < hw * ca; i += blockDim.x) {
    const size_t gp = (size_t)b * hw + i / ca;
    const int c = i % ca;
    const float* st = acc + gp * acc_stride + head_off;
    const float ls = log_sigmoid(st[c] + 2.f);
    const float t = st[ca + c];
    const float x = xa[gp * ca + c];
    y[gp * c_all + c] = reverse ? x * expf(-ls) - t : (x + t) * expf(ls);
    part += ls;
  }
  for (int i = threadIdx.x; i < hw * cb; i += blockDim.x) {
    const size_t gp = (size_t)b * hw + i / cb;
    const int c = i % cb;
    y[gp * c_all + ca + c] = xb[gp * cb + c];
  }
  red[threadIdx.x] = part;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) ld[b] = reverse ? -red[0] : red[0];
}

template <typename T>
int run(const void* xa, const void* xb, const void* h0c, int h0c_batch,
        const void* win0, const void* b0, const void* const* wjs,
        const void* bj0, void* y, void* ld, void* feat, void* acc, int B,
        int H, int W, int ca, int cb, int width, int growth, int layers,
        int reverse, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (W < 1 || W > kThreads || H < 1 || B < 1) return cudaErrorInvalidValue;
  int th = H < kThreads / W ? H : kThreads / W;
  while (th > 1 && (th + 2) * (W + 2) > kMaxTile) --th;
  if ((th + 2) * (W + 2) > kMaxTile) return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(kCiTile * (th + 2) * (W + 2) + kCiTile * 9 * kCoTile) *
      sizeof(float);
  const int rows = (H + th - 1) / th;
  const int total0 = layers * growth + 2 * ca;
  const size_t npix = (size_t)B * H * W;
  T* f0 = static_cast<T*>(feat);
  T* g = f0 + npix * width;
  float* accf = static_cast<float*>(acc);

  conv3x3_kernel<float, T, kConvIn>
      <<<dim3(rows, (width + kCoTile - 1) / kCoTile, B), kThreads, smem,
         stream>>>(static_cast<const float*>(xb), cb,
                   static_cast<const T*>(win0), width, H, W, th,
                   static_cast<const float*>(b0), static_cast<const T*>(h0c),
                   h0c_batch, f0, width, nullptr, 0, 0, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const T* src = f0;
  int src_c = width;
  for (int j = 0; j <= layers; ++j) {
    const int cout = total0 - j * growth;
    T* out = j < layers ? g + (size_t)j * npix * growth : nullptr;
    conv3x3_kernel<T, T, kJoint>
        <<<dim3(rows, (cout + kCoTile - 1) / kCoTile, B), kThreads, smem,
           stream>>>(src, src_c, static_cast<const T*>(wjs[j]), cout, H, W,
                     th, j == 0 ? static_cast<const float*>(bj0) : nullptr,
                     nullptr, 0, out, j < layers ? growth : 0, accf, total0,
                     j * growth, j == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = out;
    src_c = growth;
  }

  affine_logdet_kernel<<<B, kThreads, 0, stream>>>(
      static_cast<const float*>(xa), static_cast<const float*>(xb), accf,
      total0, layers * growth, static_cast<float*>(y),
      static_cast<float*>(ld), H * W, ca, cb, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch: feat holds B*H*W*(width + layers*growth) net-dtype values,
// acc holds B*H*W*(layers*growth + 2*ca) floats. h0c may be null
// (h0c_batch 0), else its batch is 1 or B. Returns a cudaError_t.
int tpf_fused_coupling_f32(const void* xa, const void* xb, const void* h0c,
                           int h0c_batch, const void* win0, const void* b0,
                           const void* const* wjs, const void* bj0, void* y,
                           void* ld, void* feat, void* acc, int B, int H,
                           int W, int ca, int cb, int width, int growth,
                           int layers, int reverse, void* stream) {
  return run<float>(xa, xb, h0c, h0c_batch, win0, b0, wjs, bj0, y, ld, feat,
                    acc, B, H, W, ca, cb, width, growth, layers, reverse,
                    stream);
}

int tpf_fused_coupling_bf16(const void* xa, const void* xb, const void* h0c,
                            int h0c_batch, const void* win0, const void* b0,
                            const void* const* wjs, const void* bj0, void* y,
                            void* ld, void* feat, void* acc, int B, int H,
                            int W, int ca, int cb, int width, int growth,
                            int layers, int reverse, void* stream) {
  return run<__nv_bfloat16>(xa, xb, h0c, h0c_batch, win0, b0, wjs, bj0, y,
                            ld, feat, acc, B, H, W, ca, cb, width, growth,
                            layers, reverse, stream);
}

}  // extern "C"

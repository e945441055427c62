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
// Two numerics (round_outputs, bf16 only; at f32 rounding is the identity):
//   0, the JAX package's fused coupling: the sums above stay f32.
//   1, its default XLA path (model.use_pallas false): with r() the
//      round-to-nearest bf16 of an f32 value, conv_in gives
//      r(r(r(conv) + r(b0)) + h0c), joint_0 r(r(conv) + r(bj0)), and a
//      joint j > 0 adds into each target as acc = r(acc + r(conv)). The
//      running sums keep their f32 slots and hold bf16 values; the head
//      (raw, t) is the rounded target L.
//
// What bounds it on this card: operations. At the rollout's shapes a
// launch does 104k-166k MACs per pixel against ~0.5 KB of HBM traffic per
// pixel, far above the H100's ~295 FLOP/byte ridge, so the bf16 path has
// to run on the tensor cores. Two paths, chosen by the net dtype:
//
// bfloat16 (the rollout's and training's dtype): each layer is one
// implicit GEMM on the tensor cores, mma.sync m16n8k16 with bf16 operands
// and f32 accumulation (the same numerics as the TPU kernel). M is a tile
// of one member's pixels (whole image rows, up to 256), N the layer's
// whole cout, K is 9 * cin walked tap by tap. Everything a block reads
// comes into shared memory by cp.async before the first product, so no
// load in a loop waits a round trip: its input rows plus a 1-pixel zero
// border as bf16, with a padded pixel stride (cin_pad + 8 values: an odd
// multiple of 16 bytes, so the 8 row addresses of an ldmatrix fall in
// distinct banks); the weights (cin_pad x N per tap), all nine taps where
// they fit, else through a ring of one-tap buffers two taps ahead of the
// tensor cores; and the tile of running target sums its epilogue adds to
// (conv_in: the h0c tile). A tap's A operand is the halo tile shifted by
// (dy, dx): ldmatrix takes one row address per lane, so the shift costs no
// copy. The B operand (K x N, row major) is read with ldmatrix.trans. Each
// warp holds 64 pixels x 32 columns of f32 accumulators. The epilogue
// adds the bias, h0c or running sums in registers, stages the finished
// tile in shared memory over the dead halo and weights, and copies it out
// in 16-byte stores: relu features as bf16, the rest of the running sums
// as f32. The last joint layer's epilogue instead does the affine apply
// and one logdet partial per (member, tile); ld_reduce_kernel sums each member's partials in a fixed
// order, so the logdet is bit-identical from launch to launch (no float
// atomics). Intermediates (relu features in bf16, the growth targets in
// f32) still go through device memory between layers, six launches per
// coupling; keeping the chain on chip needs space tiling with a 5-pixel
// halo (one scale-0 member's padded bf16 plane is ~281 KiB, over the
// 227 KB a block may use) and wgmma + TMA.
//
// float32 (the parity and invertibility checks): direct 3x3 convs on the
// CUDA cores in f32 FMA. bf16 tensor cores cannot give f32 products and
// TF32 would break the f32 invertibility gate, so this path stays simple.
//
// Every tile plan, padding and stride is computed in Python
// (coupling_fused.tile_plan) and passed in; the kernels only follow it.
//
// Layout: NHWC, contiguous. Packed weights are (9*Cin, n_pad) in the net
// dtype, rows ordered (dy, dx, cin) (HWIO reshaped), columns cout padded
// with zeros up to n_pad (a multiple of 8, so each row is a whole number
// of 16-byte chunks); biases are float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;  // f32 path: one output pixel per thread
constexpr int kCoTile = 16;    // f32 path: output channels per thread
constexpr int kCiTile = 16;    // f32 path: input channels staged per pass
constexpr int kMaxTile = 576;  // f32 path: (th+2)*(W+2) cap, smem < 48 KB

constexpr int kWarpM = 64;            // bf16 path: pixels per warp (4 x m16)
constexpr int kWarpN = 32;            // bf16 path: columns per warp (4 x n8)
constexpr int kMaxMmaThreads = 512;   // bf16 path: 16 warps at most
constexpr int kMaxSmem = 232448;      // 227 KB, the most a block may use
constexpr int kRing = 3;              // bf16 path: one-tap weight buffers
constexpr int kMaxDevices = 64;       // cards one process may launch on

typedef __nv_bfloat16 bf16;

// relu that keeps NaN, like jnp.maximum(x, 0) and torch.relu.
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// Round to the nearest bf16 value, kept as f32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return x < 0.f ? x - log1pf(expf(x)) : -log1pf(expf(-x));
}

enum Mode { kConvIn = 0, kJoint = 1, kJointLast = 2 };

// ---------------------------------------------------------------------------
// float32 path: CUDA cores.

// 3x3 SAME conv of one member's row tile, kCoTile output channels per
// block column. Grid: (row tiles, ceil(cout / kCoTile), B).
//   kConvIn: v = conv + bias + h0c (h0c batch 1 broadcasts, may be null);
//            feat_out[:, co] = relu(v) in the net dtype (relu_cols = cout).
//   kJoint:  v = first ? conv + bias : acc + conv at global column
//            acc_off + co; columns co < relu_cols finish the current growth
//            target and go to feat_out as relu(v); the rest stay in acc.
// Weight rows are ldw values apart.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ in, int cin,
               const float* __restrict__ wgt, int ldw, int cout, int H, int W,
               int th, const float* __restrict__ bias,
               const float* __restrict__ h0c, int h0c_batch,
               float* __restrict__ feat_out, int relu_cols,
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
        v = in[(((size_t)b * H + gr) * W + gc) * cin + gci];
      s_in[ci * tile + pix] = v;
    }
    // Stage this block's weight columns for the channel chunk.
    for (int i = threadIdx.x; i < kCiTile * 9 * kCoTile; i += blockDim.x) {
      const int k = i % kCoTile, tap = (i / kCoTile) % 9, ci = i / (9 * kCoTile);
      const int gci = ci0 + ci, co = co0 + k;
      float v = 0.f;
      if (gci < cin && co < cout)
        v = wgt[((size_t)tap * cin + gci) * ldw + co];
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
        v += h0c[(hb * H * W + plane) * cout + co];
      }
      feat_out[pix * cout + co] = relu(v);
    } else {
      float* dst = acc + pix * acc_stride + acc_off + co;
      v = first ? v + bias[co] : *dst + v;
      if (co < relu_cols)
        feat_out[pix * relu_cols + co] = relu(v);
      else
        *dst = v;
    }
  }
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

int run_f32(const void* xa, const void* xb, const void* h0c, int h0c_batch,
            const void* win0, const void* b0, const void* const* wjs,
            const void* bj0, void* y, void* ld, void* feat, void* acc, int B,
            int H, int W, int ca, int cb, int width, int growth, int layers,
            int reverse, const int* ldw, cudaStream_t stream) {
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
  float* f0 = static_cast<float*>(feat);
  float* g = f0 + npix * width;
  float* accf = static_cast<float*>(acc);

  conv3x3_kernel<kConvIn>
      <<<dim3(rows, (width + kCoTile - 1) / kCoTile, B), kThreads, smem,
         stream>>>(static_cast<const float*>(xb), cb,
                   static_cast<const float*>(win0), ldw[0], width, H, W, th,
                   static_cast<const float*>(b0), static_cast<const float*>(h0c),
                   h0c_batch, f0, width, nullptr, 0, 0, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float* src = f0;
  int src_c = width;
  for (int j = 0; j <= layers; ++j) {
    const int cout = total0 - j * growth;
    float* out = j < layers ? g + (size_t)j * npix * growth : nullptr;
    conv3x3_kernel<kJoint>
        <<<dim3(rows, (cout + kCoTile - 1) / kCoTile, B), kThreads, smem,
           stream>>>(src, src_c, static_cast<const float*>(wjs[j]), ldw[1 + j],
                     cout, H, W, th,
                     j == 0 ? static_cast<const float*>(bj0) : nullptr,
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

// ---------------------------------------------------------------------------
// bfloat16 path: tensor cores.

// One layer's tile plan, from coupling_fused.tile_plan (same field order).
struct Plan {
  int rows;      // image rows per tile
  int tiles;     // row tiles per member (grid.x)
  int warps_m;   // warps along the pixels, kWarpM each
  int warps_n;   // warps along the columns, kWarpN each
  int cin_pad;   // K per tap: cin rounded up to 16
  int a_stride;  // halo pixel stride in shared memory, bf16 values
  int n_pad;     // weight row stride in device memory: cout rounded up to 8
  int n16;       // columns that ldmatrix reads: n_pad rounded up to 16
  int b_stride;  // weight row stride in shared memory, bf16 values
  int taps;      // taps per weight buffer: 9 (all resident) or 1 (a ring)
  int nbuf;      // weight buffers: 1 with taps = 9, else kRing
  int t_stride;  // row stride of the shared tiles (h0c, running sums,
                 // output stage), in values: >= cout, 4k but not 16k
  int ld_out;    // feat_out's pixel stride: the next layer's cin_pad
  int ld_acc;    // acc's pixel stride, a multiple of 4 floats
  int b_off;     // byte offset of the weight buffers
  int x_off;     // byte offset of conv_in's f32 input rows
  int t_off;     // byte offset of conv_in's h0c tile (bf16) or of the
                 // running sums a joint layer adds to (f32); the output
                 // stage (f32) lies at 0, over everything but the logdet's
  int red_off;   // byte offset of the logdet's per-warp sums (last layer)
  int smem;      // dynamic shared memory bytes
};
constexpr int kPlanInts = sizeof(Plan) / sizeof(int);

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy of the first `bytes` (0..16) bytes; the
// rest of the 16 are written as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4-byte global -> shared copy; bytes = 0 writes 4 zero bytes instead.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row major) * b (16x8, column major); bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One layer as an implicit GEMM on the tensor cores. Grid: (p.tiles, B);
// block: p.warps_m * p.warps_n warps; p.smem bytes of dynamic shared memory.
// Everything a block reads from device memory is copied into shared memory
// by cp.async up front (no load in the loops waits a round trip): the input
// halo, the weights, and the tile of values its epilogue adds to. By MODE:
//   kConvIn:    v = conv + bias + h0c; feat_out = relu(v) in bf16. The input
//               is xb in f32: its rows are copied as they are, then rounded
//               to bf16 into the halo. h0c's rows are copied whole when
//               they are whole 16-byte chunks, else read in the epilogue.
//   kJoint:     v = first ? conv + bias : acc + conv, where acc's row of a
//               pixel starts with this layer's targets; columns co <
//               relu_cols finish the current growth target and go to
//               feat_out as relu(v); the rest go back to acc at column
//               co - relu_cols, so the next layer's targets start the row.
//               (A block copies all of its rows' values into shared
//               memory before it writes any, and no other block reads
//               them, so the shift is safe in place.)
//   kJointLast: v as kJoint is target L = (raw, t); the block applies the
//               affine to its pixels from the output stage, writes y =
//               [ya, xb] and one logdet partial to ld_part[b * p.tiles +
//               tile].
// round_outputs: each sum above in the default path's bf16 rounding (see
// the top of the file).
// The feature buffers a joint layer reads have pixel stride cin_pad (its
// producer's ld_out), so their halo is copied in whole 16-byte chunks; the
// copies zero-fill past cin and past cout, so pad columns are never read.
template <int MODE>
__global__ void __launch_bounds__(kMaxMmaThreads)
conv3x3_mma_kernel(const void* __restrict__ in_, int cin,
                   const bf16* __restrict__ wgt, int cout, int H, int W,
                   Plan p, const float* __restrict__ bias,
                   const bf16* __restrict__ h0c, int h0c_batch,
                   bf16* __restrict__ feat_out, int relu_cols,
                   float* __restrict__ acc, int first,
                   const float* __restrict__ xa,
                   const float* __restrict__ xb, float* __restrict__ y,
                   float* __restrict__ ld_part, int ca, int cb, int reverse,
                   int round_outputs) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  bf16* s_a = reinterpret_cast<bf16*>(dsmem);
  bf16* s_b = reinterpret_cast<bf16*>(dsmem + p.b_off);
  float* s_t = reinterpret_cast<float*>(dsmem + p.t_off);   // running sums
  bf16* s_h = reinterpret_cast<bf16*>(dsmem + p.t_off);     // h0c tile
  float* s_o = reinterpret_cast<float*>(dsmem);             // output stage
  const bool h0c_tile = h0c != nullptr && (cout & 7) == 0;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * p.rows;
  const int hw = W + 2;
  const int hpix = (p.rows + 2) * hw;
  const int m_tile = p.rows * W;                // pixels of the tile, whole rows
  const int m_valid = min(p.rows, H - r0) * W;  // of them inside the image
  const size_t pix0 = (size_t)b * H * W + (size_t)r0 * W;

  // The input halo: rows r0-1 .. r0+rows plus a zero border, channels
  // cin .. cin_pad zero, in bf16.
  if (MODE == kConvIn) {
    // xb's rows are contiguous: copy them as f32 (rows outside the image
    // zero), wait, then round into the halo.
    const float* in = static_cast<const float*>(in_);
    float* s_x = reinterpret_cast<float*>(dsmem + p.x_off);
    const int row_vals = W * cin;
    const long long base = ((long long)b * H + r0 - 1) * row_vals;
    for (int i = tid; i < (p.rows + 2) * row_vals; i += nthreads) {
      const int gr = r0 - 1 + i / row_vals;
      const bool ok = gr >= 0 && gr < H;
      cp_async4(s_x + i, ok ? in + base + i : in, ok ? 4 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < hpix * p.cin_pad; i += nthreads) {
      const int pix = i / p.cin_pad, ch = i - pix * p.cin_pad;
      const int hr = pix / hw, gc = pix - hr * hw - 1;
      const float v =
          gc >= 0 && gc < W && ch < cin ? s_x[(hr * W + gc) * cin + ch] : 0.f;
      s_a[pix * p.a_stride + ch] = __float2bfloat16(v);
    }
    // The first barrier of the tap loop orders these stores before the mma.
    if (h0c_tile) {
      // This member's (or the broadcast) h0c rows, whole 16-byte chunks.
      const bf16* src =
          h0c + ((h0c_batch == 1 ? 0 : (size_t)b) * H * W + (size_t)r0 * W) * cout;
      const int cpr = cout / 8;
      for (int i = tid; i < m_valid * cpr; i += nthreads) {
        const int pm = i / cpr, c = (i - pm * cpr) * 8;
        cp_async16(s_h + pm * p.t_stride + c, src + (size_t)pm * cout + c, 16);
      }
    }
  } else {
    const bf16* in = static_cast<const bf16*>(in_);
    const int cpp = p.cin_pad / 8;  // 16-byte chunks per pixel
    for (int i = tid; i < hpix * cpp; i += nthreads) {
      const int pix = i / cpp, ch = (i - pix * cpp) * 8;
      const int gr = r0 - 1 + pix / hw, gc = pix % hw - 1;
      const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W && ch < cin;
      const bf16* src =
          ok ? in + (((size_t)b * H + gr) * W + gc) * p.cin_pad + ch : in;
      cp_async16(s_a + pix * p.a_stride + ch, src, ok ? 2 * min(8, cin - ch) : 0);
    }
    if (!first) {
      // The targets' running sums this layer adds to: the first cout
      // floats of its pixels' acc rows, into rows t_stride apart.
      const float* src = acc + pix0 * p.ld_acc;
      const int cpr = (cout + 3) / 4;
      for (int i = tid; i < m_valid * cpr; i += nthreads) {
        const int pm = i / cpr, c = (i - pm * cpr) * 4;
        cp_async16(s_t + pm * p.t_stride + c, src + (size_t)pm * p.ld_acc + c,
                   4 * min(4, cout - c));
      }
    }
  }

  // A buffer holds p.taps taps of cin_pad x n16 weights; rows cin ..
  // cin_pad and columns n_pad .. n16 are zero-filled by the copy itself.
  const int buf_vals = p.taps * p.cin_pad * p.b_stride;
  auto load_taps = [&](int tap0, int buf) {
    bf16* dst = s_b + buf * buf_vals;
    const int cpr = p.n16 / 8;  // 16-byte chunks per shared-memory row
    const int n = p.taps * p.cin_pad * cpr;
    for (int i = tid; i < n; i += nthreads) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      const int t = r / p.cin_pad, k = r - t * p.cin_pad;
      const bool ok = k < cin && c < p.n_pad;
      const bf16* src = ok ? wgt + ((size_t)(tap0 + t) * cin + k) * p.n_pad + c : wgt;
      cp_async16(dst + r * p.b_stride + c, src, ok ? 16 : 0);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % p.warps_m, wn = warp / p.warps_m;
  const int n0 = wn * kWarpN;
  // ldmatrix row addresses. A: lane l gives pixel row l % 16 of an m16
  // tile, k offset 8 * (l / 16). Pixels past the tile read pixel 0 (their
  // results are dropped).
  int a_base[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int pm = wm * kWarpM + i * 16 + (lane & 15);
    if (pm >= m_tile) pm = 0;
    a_base[i] = ((pm / W) * hw + pm % W) * p.a_stride + (lane >> 4) * 8;
  }
  // B (.trans): lane l gives k row (l & 7) + 8 * ((l >> 3) & 1) at column
  // n0 + 8 * (l >> 4) of an n16 pair.
  const int b_base =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * p.b_stride + n0 + (lane >> 4) * 8;

  float accum[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accum[i][j][e] = 0.f;

  // One tap: K = cin_pad in steps of 16 against the weights at sb.
  auto mma_tap = [&](int tap, const bf16* sb) {
    sb += b_base;
    const bf16* sa = s_a + ((tap / 3) * hw + tap % 3) * p.a_stride;
    for (int k0 = 0; k0 < p.cin_pad; k0 += 16) {
      unsigned af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(af[i], sa + a_base[i] + k0);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (n0 + 16 * q < p.n_pad)
          ldmatrix_x4_trans(bfr[q], sb + k0 * p.b_stride + 16 * q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + 8 * j < p.n_pad) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma_bf16(accum[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                     bfr[j >> 1][(j & 1) * 2 + 1]);
        }
      }
    }
  };

  if (p.taps == 9) {
    // All nine taps resident: one copy (with the halo and the tile), one
    // wait.
    load_taps(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) mma_tap(tap, s_b + tap * p.cin_pad * p.b_stride);
  } else {
    // A ring of kRing one-tap buffers, kRing - 1 taps in flight; group k
    // holds tap k (group 0 also the halo and the tile). One barrier per
    // tap: after it, every warp is done with the buffer that the next copy
    // overwrites.
    for (int t = 0; t < kRing - 1; ++t) {
      load_taps(t, t);
      cp_async_commit();
    }
    for (int tap = 0; tap < 9; ++tap) {
      cp_async_wait<kRing - 2>();
      __syncthreads();
      const int next = tap + kRing - 1;
      if (next < 9) load_taps(next, next % kRing);
      cp_async_commit();
      mma_tap(tap, s_b + (tap % kRing) * buf_vals);
    }
  }

  // Epilogue. Fragment (i, j) holds rows g and g + 8 of m16 tile i and
  // columns 2 * t4, 2 * t4 + 1 of n8 tile j. First, in registers: + bias
  // (conv_in, joint_0), + h0c (conv_in), + the running sums (the other
  // joints), each sum rounded to bf16 with round_outputs. A column past
  // cout (odd cout) takes junk that nothing copies out.
  const int g = lane >> 2, t4 = lane & 3;
  auto bias_at = [&](int c) { return c < cout ? bias[c] : 0.f; };
  auto add = [&](float a, float b) {
    return round_outputs ? round_bf16(a + round_bf16(b)) : a + b;
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pm = wm * kWarpM + i * 16 + g + 8 * h;
      if (pm >= m_valid) continue;
      const size_t hrow = (h0c_batch == 1 ? 0 : (size_t)b) * H * W + (size_t)r0 * W + pm;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 8 * j + 2 * t4;
        if (c >= cout) continue;
        float* v = &accum[i][j][2 * h];
        if (MODE == kConvIn || first) {
          // r(r(conv) + r(bias)): add(a, b) is r(a + r(b)).
          if (round_outputs) v[0] = round_bf16(v[0]), v[1] = round_bf16(v[1]);
          v[0] = add(v[0], bias_at(c));
          v[1] = add(v[1], bias_at(c + 1));
        } else {
          // r(acc + r(conv)): the running sums already hold bf16 values.
          v[0] = add(s_t[pm * p.t_stride + c], v[0]);
          v[1] = add(s_t[pm * p.t_stride + c + 1], v[1]);
        }
        // h0c is bf16 already, so add() rounds only the sum.
        if (MODE == kConvIn && h0c_tile) {
          v[0] = add(v[0], __bfloat162float(s_h[pm * p.t_stride + c]));
          v[1] = add(v[1], __bfloat162float(s_h[pm * p.t_stride + c + 1]));
        } else if (MODE == kConvIn && h0c != nullptr) {
          v[0] = add(v[0], __bfloat162float(h0c[hrow * cout + c]));
          if (c + 1 < cout) v[1] = add(v[1], __bfloat162float(h0c[hrow * cout + c + 1]));
        }
      }
    }
  }
  // Then the stage: every warp is done with the halo, the weights and the
  // tiles it overwrites.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pm = wm * kWarpM + i * 16 + g + 8 * h;
      if (pm >= m_valid) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 8 * j + 2 * t4;
        if (c < cout)
          *reinterpret_cast<float2*>(s_o + pm * p.t_stride + c) =
              make_float2(accum[i][j][2 * h], accum[i][j][2 * h + 1]);
      }
    }
  }
  __syncthreads();

  if (MODE != kJointLast) {
    // Copy out, 16 bytes a store; pad columns get zeros. relu(v) of
    // columns < relu_cols to feat_out (conv_in: all of them), bf16, 8 a
    // chunk; v of the rest to acc at column - relu_cols, f32, 4 a chunk.
    const int fc = (relu_cols + 7) / 8;
    for (int i = tid; i < m_valid * fc; i += nthreads) {
      const int pm = i / fc, c = (i - pm * fc) * 8;
      const float* src = s_o + pm * p.t_stride + c;
      unsigned q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 two = __floats2bfloat162_rn(
            c + 2 * e < relu_cols ? relu(src[2 * e]) : 0.f,
            c + 2 * e + 1 < relu_cols ? relu(src[2 * e + 1]) : 0.f);
        q[e] = *reinterpret_cast<const unsigned*>(&two);
      }
      *reinterpret_cast<uint4*>(feat_out + (pix0 + pm) * p.ld_out + c) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
    if (MODE == kConvIn) return;
    const int rest = cout - relu_cols, ac = (rest + 3) / 4;
    for (int i = tid; i < m_valid * ac; i += nthreads) {
      const int pm = i / ac, c = (i - pm * ac) * 4;
      const float* src = s_o + pm * p.t_stride + relu_cols + c;
      *reinterpret_cast<float4*>(acc + (pix0 + pm) * p.ld_acc + c) =
          make_float4(src[0], c + 1 < rest ? src[1] : 0.f, c + 2 < rest ? src[2] : 0.f,
                      c + 3 < rest ? src[3] : 0.f);
    }
    return;
  }

  // Affine apply and this tile's logdet partial, from the stage.
  const int c_all = ca + cb;
  float part = 0.f;
  for (int i = tid; i < m_valid * ca; i += nthreads) {
    const int pm = i / ca, c = i - pm * ca;
    const float ls = log_sigmoid(s_o[pm * p.t_stride + c] + 2.f);
    const float t = s_o[pm * p.t_stride + ca + c];
    const size_t gp = pix0 + pm;
    const float x = xa[gp * ca + c];
    y[gp * c_all + c] = reverse ? x * expf(-ls) - t : (x + t) * expf(ls);
    part += ls;
  }
  for (int i = tid; i < m_valid * cb; i += nthreads) {
    const size_t gp = pix0 + i / cb;
    const int c = i % cb;
    y[gp * c_all + ca + c] = xb[gp * cb + c];
  }
  // Fixed-order reduction: each warp by shuffles, then warp sums in order.
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) part += __shfl_down_sync(0xffffffffu, part, s);
  float* red = reinterpret_cast<float*>(dsmem + p.red_off);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < nthreads / 32; ++w) s += red[w];
    ld_part[(size_t)b * p.tiles + tile] = s;
  }
}

// ld[b] = (reverse ? -1 : 1) * sum of member b's tile partials, in order.
__global__ void ld_reduce_kernel(const float* __restrict__ ld_part, int tiles,
                                 float* __restrict__ ld, int B, int reverse) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += ld_part[(size_t)b * tiles + t];
  ld[b] = reverse ? -s : s;
}

template <int MODE>
cudaError_t launch_mma(const Plan& p, int B, cudaStream_t stream,
                       const void* in, int cin, const bf16* wgt, int cout,
                       int H, int W, const float* bias, const bf16* h0c,
                       int h0c_batch, bf16* feat_out, int relu_cols,
                       float* acc, int first,
                       const float* xa, const float* xb, float* y,
                       float* ld_part, int ca, int cb, int reverse,
                       int round_outputs) {
  // Above 48 KB a block's dynamic shared memory must be allowed first, on
  // each device (a function's attributes belong to one device's context:
  // a process that drives several cards launches on each); done once per
  // instantiation and device, at its first launch there.
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(
        conv3x3_mma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const int threads = p.warps_m * p.warps_n * 32;
  const bool buffers = (p.taps == 9 && p.nbuf == 1) || (p.taps == 1 && p.nbuf == kRing);
  if (p.smem > kMaxSmem || threads > kMaxMmaThreads || threads < 32 || !buffers)
    return cudaErrorInvalidValue;
  conv3x3_mma_kernel<MODE><<<dim3(p.tiles, B), threads, p.smem, stream>>>(
      in, cin, wgt, cout, H, W, p, bias, h0c, h0c_batch, feat_out, relu_cols,
      acc, first, xa, xb, y, ld_part, ca, cb, reverse, round_outputs);
  return cudaGetLastError();
}

int run_bf16(const void* xa, const void* xb, const void* h0c, int h0c_batch,
             const void* win0, const void* b0, const void* const* wjs,
             const void* bj0, void* y, void* ld, void* feat, void* acc,
             void* ld_part, int B, int H, int W, int ca, int cb, int width,
             int growth, int layers, int reverse, int round_outputs,
             const int* plans, cudaStream_t stream) {
  if (W < 1 || H < 1 || B < 1) return cudaErrorInvalidValue;
  const Plan* plan = reinterpret_cast<const Plan*>(plans);
  const size_t npix = (size_t)B * H * W;
  float* accf = static_cast<float*>(acc);
  const float* xa_ = static_cast<const float*>(xa);
  const float* xb_ = static_cast<const float*>(xb);
  float* y_ = static_cast<float*>(y);
  float* part = static_cast<float*>(ld_part);

  // feat holds relu(h0) and then each finished growth target, each
  // buffer npix pixels of its plan's ld_out values.
  bf16* out = static_cast<bf16*>(feat);
  cudaError_t err = launch_mma<kConvIn>(
      plan[0], B, stream, xb, cb, static_cast<const bf16*>(win0), width, H, W,
      static_cast<const float*>(b0), static_cast<const bf16*>(h0c), h0c_batch,
      out, width, nullptr, 1, nullptr, nullptr, nullptr, nullptr, 0, 0, 0,
      round_outputs);
  if (err != cudaSuccess) return err;

  int cout = layers * growth + 2 * ca;
  for (int j = 0; j <= layers; ++j, cout -= growth) {
    const bf16* src = out;
    out += npix * plan[j].ld_out;
    const bf16* w = static_cast<const bf16*>(wjs[j]);
    const float* bias = j == 0 ? static_cast<const float*>(bj0) : nullptr;
    const int cin = j == 0 ? width : growth;
    if (j < layers)
      err = launch_mma<kJoint>(plan[1 + j], B, stream, src, cin, w, cout, H, W,
                               bias, nullptr, 0, out, growth, accf, j == 0,
                               nullptr, nullptr, nullptr, nullptr, 0, 0, 0,
                               round_outputs);
    else
      err = launch_mma<kJointLast>(plan[1 + j], B, stream, src, cin, w, cout,
                                   H, W, bias, nullptr, 0, nullptr, 0, accf,
                                   j == 0, xa_, xb_, y_, part, ca, cb, reverse,
                                   round_outputs);
    if (err != cudaSuccess) return err;
  }
  const int tiles = plan[1 + layers].tiles;
  ld_reduce_kernel<<<(B + 127) / 128, 128, 0, stream>>>(
      part, tiles, static_cast<float*>(ld), B, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ints per layer in the bf16 entry's plans array (coupling_fused checks it).
int tpf_plan_ints() { return kPlanInts; }

// Scratch: feat holds B*H*W*(width + layers*growth) net-dtype values,
// acc holds B*H*W*(layers*growth + 2*ca) floats. h0c may be null
// (h0c_batch 0), else its batch is 1 or B. round_outputs is ignored: at
// f32 the default path's rounding is the identity. ldw: the packed
// weights' row strides, conv_in then joint_0..L. Returns a cudaError_t.
int tpf_fused_coupling_f32(const void* xa, const void* xb, const void* h0c,
                           int h0c_batch, const void* win0, const void* b0,
                           const void* const* wjs, const void* bj0, void* y,
                           void* ld, void* feat, void* acc, int B, int H,
                           int W, int ca, int cb, int width, int growth,
                           int layers, int reverse, int round_outputs,
                           const int* ldw, void* stream) {
  (void)round_outputs;
  return run_f32(xa, xb, h0c, h0c_batch, win0, b0, wjs, bj0, y, ld, feat,
                 acc, B, H, W, ca, cb, width, growth, layers, reverse, ldw,
                 static_cast<cudaStream_t>(stream));
}

// As the f32 entry, except the scratch: feat holds B*H*W times the sum of
// the plans' ld_out bf16 values, acc B*H*W*ld_acc floats, ld_part B * (the
// last layer's tiles) floats. round_outputs: 1 for the default path's
// numerics, 0 for the fused coupling's. plans: (layers + 2) *
// tpf_plan_ints() ints, conv_in then joint_0..L.
int tpf_fused_coupling_bf16(const void* xa, const void* xb, const void* h0c,
                            int h0c_batch, const void* win0, const void* b0,
                            const void* const* wjs, const void* bj0, void* y,
                            void* ld, void* feat, void* acc, void* ld_part,
                            int B, int H, int W, int ca, int cb, int width,
                            int growth, int layers, int reverse,
                            int round_outputs, const int* plans,
                            void* stream) {
  return run_bf16(xa, xb, h0c, h0c_batch, win0, b0, wjs, bj0, y, ld, feat,
                  acc, ld_part, B, H, W, ca, cb, width, growth, layers,
                  reverse, round_outputs, plans,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// Fused CGM correlation + conv3 projection for one pyramid level, the whole
// batch in one launch.
//
// Replaces the JAX package's Pallas TPU kernel
// faster_orefsdet_tpu/ops/pallas_cgm.py::_cgm_kernel. Per pixel, with
// q [B,H,W,C] (the channels-last memory of an NCHW map), C = 128:
//
//   c2   = relu(relu(q * k1) * k1)
//   d1   = relu(stencil_w(q, k13))          3 taps along W, zero padded
//   d2   = relu(stencil_h(d1, k31))         3 taps along H, zero padded
//   attn = c2 + d2 + q
//   out  = relu(attn . W3a + q . W3b + b3)  W3 = [W3a; W3b], [2C, C]
//
// All arithmetic is f32; q may be bf16 or f32 and is widened on load, which
// is exact. The projection is the concat-free split of the reference's
// 1x1 conv over concat(attn, q).
//
// What bounds it on the card: its device-memory traffic is one read of q
// and one write of out per level (the taps, W3 and b3, 132 KB, stay in L2),
// against 2*2C operations per output value for the projection. Run on the
// f32 CUDA cores (not the tensor cores, so that the result matches the plain
// f32 version to 1e-5), those operations, not the bytes, bound this design.
//
// Design: each block owns one output row h of one image and a tile of TW
// columns. Phase 1 computes attn and q of the tile into shared memory; it
// evaluates d1 on all three rows h-1..h+1 because the H stencil reads the
// post-relu d1 of the neighbouring rows, not q. The nine q reads per value
// hit L1. Phase 2 gives each thread one output channel and TW/2 pixels: it
// reads W3 column-wise (coalesced across the warp, L2-resident) and the
// pixel's 256 inputs from shared memory (a broadcast within the warp), and
// accumulates the 256-term dot products in registers. Epilogue: + b3, relu.
// Tensor-core products (wgmma) fed by TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int C = 128;
constexpr int TW = 32;            // pixels (columns) per block
constexpr int THREADS = 256;      // 2 pixel groups x 128 output channels
constexpr int PIX_PER_THREAD = TW / (THREADS / C);

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cgm_kernel(const T* __restrict__ q, const float* __restrict__ k1,
           const float* __restrict__ k13, const float* __restrict__ k31,
           const float* __restrict__ w3, const float* __restrict__ b3,
           float* __restrict__ out, int H, int W) {
  __shared__ float a[TW][2 * C];  // [attn | q] per pixel, 32 KB

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int w0 = blockIdx.x * TW;
  const T* qb = q + (size_t)b * H * W * C;

  // ---- phase 1: attn and q of the tile
  for (int idx = threadIdx.x; idx < TW * C; idx += THREADS) {
    const int p = idx / C;
    const int c = idx % C;
    const int w = w0 + p;
    float qc = 0.f, attn = 0.f;
    if (w < W) {
      const T* row = qb + ((size_t)h * W + w) * C + c;
      qc = load_f32(row);
      const float kc = k1[c];
      const float c2 = fmaxf(fmaxf(qc * kc, 0.f) * kc, 0.f);
      const float t0 = k13[c], t1 = k13[C + c], t2 = k13[2 * C + c];
      float d2 = 0.f;
      for (int r = 0; r < 3; ++r) {
        const int hh = h + r - 1;
        if (hh < 0 || hh >= H) continue;
        const T* pr = qb + ((size_t)hh * W + w) * C + c;
        const float left = w > 0 ? load_f32(pr - C) : 0.f;
        const float mid = load_f32(pr);
        const float right = w + 1 < W ? load_f32(pr + C) : 0.f;
        const float d1 = fmaxf(left * t0 + mid * t1 + right * t2, 0.f);
        d2 += d1 * k31[r * C + c];
      }
      d2 = fmaxf(d2, 0.f);
      attn = c2 + d2 + qc;
    }
    a[p][c] = attn;
    a[p][C + c] = qc;
  }
  __syncthreads();

  // ---- phase 2: out[p, o] = relu(sum_k a[p, k] * w3[k, o] + b3[o])
  const int o = threadIdx.x % C;
  const int p0 = (threadIdx.x / C) * PIX_PER_THREAD;
  float acc[PIX_PER_THREAD];
#pragma unroll
  for (int i = 0; i < PIX_PER_THREAD; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int k = 0; k < 2 * C; ++k) {
    const float wv = __ldg(w3 + k * C + o);
#pragma unroll
    for (int i = 0; i < PIX_PER_THREAD; ++i) acc[i] += a[p0 + i][k] * wv;
  }
  const float bias = b3[o];
  float* ob = out + ((size_t)b * H + h) * W * C;
#pragma unroll
  for (int i = 0; i < PIX_PER_THREAD; ++i) {
    const int w = w0 + p0 + i;
    if (w < W) ob[(size_t)w * C + o] = fmaxf(acc[i] + bias, 0.f);
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B,H,W,C] (bf16 if q_is_bf16 else f32); k1 [C]; k13, k31 [3,C];
// w3 [2C,C]; b3 [C]; out [B,H,W,C] f32. All contiguous, on the device.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int cgm_forward(const void* q, int q_is_bf16, const void* k1,
                           const void* k13, const void* k31, const void* w3,
                           const void* b3, void* out, int B, int H, int W,
                           int channels, void* stream) {
  if (channels != C || B <= 0 || H <= 0 || W <= 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + TW - 1) / TW, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fk1 = static_cast<const float*>(k1);
  const float* fk13 = static_cast<const float*>(k13);
  const float* fk31 = static_cast<const float*>(k31);
  const float* fw3 = static_cast<const float*>(w3);
  const float* fb3 = static_cast<const float*>(b3);
  float* fout = static_cast<float*>(out);
  if (q_is_bf16)
    cgm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), fk1, fk13, fk31, fw3, fb3, fout, H, W);
  else
    cgm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), fk1, fk13, fk31, fw3, fb3, fout, H, W);
  return static_cast<int>(cudaGetLastError());
}

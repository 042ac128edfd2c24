// ROIAlignV2 (aligned = True) by gathering: every box pooled once, at its own
// pyramid level, straight from channel-last maps, the whole batch in one
// launch.
//
// Replaces no TPU kernel. The JAX package computes ROIAlign as two dense
// einsums over the whole map (faster_orefsdet_tpu/ops/roi_align.py), which
// the TPU's matrix unit absorbs; the port kept them as its plain version
// (ops/roi_align.py), and on the card they are batched GEMMs of depth 40-56
// whose [B, R, P, W, C] products make several round trips through memory,
// at every level, for every box (each box then keeps one level).
//
// Semantics, those of ops/roi_align.roi_align at each box's level l (scale
// s_l): x1 * s_l - 0.5 etc., width and height clamped at 1e-6; per output bin
// and axis, n = sampling_ratio (> 0) or clamp(ceil(bin), 1, 8) samples at
// start + (p + (i + 0.5) / n) * bin, each weighted 1/n; a sample outside
// [-1, L] weighs nothing, one inside is clamped to [0, L - 1] and spread
// over its two grid lines by the hat weights relu(1 - |y - h|); the output
// is the separable product of the y and x means. A box whose level index is
// outside the maps' pools to zeros (no level's mask keeps it). Sample
// positions and weights are computed with the plain version's f32 operations
// in its order (no contraction to FMA); the weighted sum runs in f32 in
// another order and is rounded once to the maps' type.
//
// What bounds it on the card: bytes. A box's P x P x C output needs
// (taps in y) x (taps in x) loads of C values an output pixel, 4 to 36 at the
// serving shapes, but those hit L1 and L2 (a batch's maps are 6 MB for
// VoVNet, 62 MB for the baseline); device memory sees the output once and
// the maps about once. The bound at each cell's shape, output plus maps at
// 3.35 TB/s: VoVNet [8, 256] x 8 x 8 x 128 bf16 over p3-p5, 40 MB, 12 us;
// DLA [8, 256] x 7 x 7 x 160 f32, about 80 MB, 24 us; the baseline [8, 100]
// x 14 x 14 x 1024 f32 over res4, 704 MB, 210 us.
//
// Design: one block per (box, output row). The block first writes its
// row's y taps and every column's x taps to shared memory, as (index,
// weight) lists with the weights of samples that share a grid line summed
// (at most 2 x samples entries, about bin + 1 when samples are dense). Then
// each thread owns 16 bytes of channels (8 bf16 or 4 f32) of one output
// pixel, so a warp reads
// neighbouring 16-byte pieces of one tap's channel row, and sums its taps
// in registers in the plain version's order: for each x tap, the y-weighted
// column (the first einsum's sum over rows), then the x-weighted sum.
// The block is P x C / (16 bytes) threads rounded up to a warp, at most
// 512, so C = 128 (bf16, P = 8), 160 (f32, P = 7) and 1024 (f32, P = 14)
// each keep whole warps busy; no atomics, no shared state between blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int ADAPTIVE_S_MAX = 8;  // ops/roi_align.ADAPTIVE_S_MAX
constexpr int MAX_THREADS = 512;
constexpr int SMEM_MAX = 48 * 1024;

struct Levels {
  const void* map[MAX_LEVELS];  // [B, H, W, C] channel-last
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  float scale[MAX_LEVELS];
  int n;
};

// Up to `cap` taps of output bin p along one axis of length `len`, as
// (index x stride, weight): each sample's two grid lines, weights of the
// same line summed (samples ascend, so a line can only repeat one of the
// last two entries). Returns the count.
__device__ __forceinline__ int axis_taps(float start, float size, int len, int stride, int p, int out_size,
                                         int ratio, int* idx, float* wt) {
  const float bin = __fdiv_rn(size, (float)out_size);
  const float s = ratio > 0 ? (float)ratio : fminf(fmaxf(ceilf(bin), 1.0f), (float)ADAPTIVE_S_MAX);
  const int n_samples = (int)s;
  const float sw = __fdiv_rn(1.0f, s);
  const float top = (float)(len - 1);
  int n = 0;
  for (int i = 0; i < n_samples; ++i) {
    const float y = __fadd_rn(start, __fmul_rn(__fadd_rn((float)p, __fdiv_rn((float)i + 0.5f, s)), bin));
    if (!(y >= -1.0f && y <= (float)len)) continue;
    const float yc = fminf(fmaxf(y, 0.0f), top);
    const int y0 = (int)floorf(yc);
    for (int h = y0; h <= y0 + 1 && h < len; ++h) {
      const float hat = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(yc, (float)h))), 0.0f);
      if (hat == 0.0f) continue;
      const float w = __fmul_rn(hat, sw);
      const int at = h * stride;
      if (n > 0 && idx[n - 1] == at) {
        wt[n - 1] += w;
      } else if (n > 1 && idx[n - 2] == at) {
        wt[n - 2] += w;
      } else {
        idx[n] = at;
        wt[n] = w;
        ++n;
      }
    }
  }
  return n;
}

// 16 bytes of channels loaded to / stored from f32 registers
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = bf16_lo(w[k]);
      v[2 * k + 1] = bf16_hi(w[k]);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  }
};

// The block's shared lists: x taps of every column [P][cap], the row's y taps [cap]
struct Taps {
  int* xi;
  float* xw;
  int* nx;
  int* yi;
  float* yw;
  int* ny;
};

__device__ __forceinline__ Taps carve(unsigned char* smem, int P, int cap) {
  Taps t;
  t.xi = reinterpret_cast<int*>(smem);
  t.xw = reinterpret_cast<float*>(t.xi + P * cap);
  t.yi = reinterpret_cast<int*>(t.xw + P * cap);
  t.yw = reinterpret_cast<float*>(t.yi + cap);
  t.nx = reinterpret_cast<int*>(t.yw + cap);
  t.ny = t.nx + P;
  return t;
}

// bytes of `carve`'s lists
size_t smem_bytes(int P, int cap) { return (size_t)(2 * P * cap + 2 * cap + P + 1) * 4; }

struct Box {
  const void* map;  // the image's map at the box's level, or null (zeros)
  int h, w;
  float sx, sy, bw, bh;
};

__device__ __forceinline__ Box box_at(const Levels& lv, const float* boxes, const int* levels, int box, int img,
                                      int C, int elem) {
  Box b = {nullptr, 1, 1, 0.0f, 0.0f, 1.0f, 1.0f};
  const int l = levels ? levels[box] : 0;
  if (l < 0 || l >= lv.n) return b;
  b.h = lv.h[l];
  b.w = lv.w[l];
  b.map = static_cast<const unsigned char*>(lv.map[l]) + (size_t)img * b.h * b.w * C * elem;
  const float s = lv.scale[l];
  const float* xy = boxes + (size_t)box * 4;
  b.sx = __fsub_rn(__fmul_rn(xy[0], s), 0.5f);
  b.sy = __fsub_rn(__fmul_rn(xy[1], s), 0.5f);
  const float ex = __fsub_rn(__fmul_rn(xy[2], s), 0.5f);
  const float ey = __fsub_rn(__fmul_rn(xy[3], s), 0.5f);
  b.bw = fmaxf(__fsub_rn(ex, b.sx), 1e-6f);
  b.bh = fmaxf(__fsub_rn(ey, b.sy), 1e-6f);
  return b;
}

// Phase 1 of a block (thread `tid` of `nthreads`): the tap lists.
__device__ __forceinline__ void block_taps(const Box& b, const Taps& t, int py, int P, int C, int ratio, int cap,
                                           int tid, int nthreads) {
  if (!b.map) return;
  for (int j = tid; j <= P; j += nthreads) {
    if (j < P)
      t.nx[j] = axis_taps(b.sx, b.bw, b.w, C, j, P, ratio, t.xi + j * cap, t.xw + j * cap);
    else
      *t.ny = axis_taps(b.sy, b.bh, b.h, b.w * C, py, P, ratio, t.yi, t.yw);
  }
}

// Phase 2: the row's P x C outputs, V channels a thread at a time.
template <typename T, int V>
__device__ __forceinline__ void block_outputs(const Box& b, const Taps& t, T* out_row, int P, int C, int cap,
                                              int tid, int nthreads) {
  const int groups = C / V;
  const T* map = static_cast<const T*>(b.map);
  for (int i = tid; i < P * groups; i += nthreads) {
    const int px = i / groups;
    const int c = (i - px * groups) * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    if (map) {
      const int nx = t.nx[px], ny = *t.ny;
      const int* xi = t.xi + px * cap;
      const float* xw = t.xw + px * cap;
      for (int e = 0; e < nx; ++e) {
        const T* col = map + (size_t)xi[e] + c;
        float r[V];
#pragma unroll
        for (int k = 0; k < V; ++k) r[k] = 0.0f;
#pragma unroll 2
        for (int a = 0; a < ny; ++a) {
          float v[V];
          Vec<T, V>::load(col + t.yi[a], v);
          const float w = t.yw[a];
#pragma unroll
          for (int k = 0; k < V; ++k) r[k] = fmaf(w, v[k], r[k]);
        }
        const float w = xw[e];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(w, r[k], acc[k]);
      }
    }
    Vec<T, V>::store(out_row + (size_t)px * C + c, acc);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    roi_align_kernel(Levels lv, const float* __restrict__ boxes, const int* __restrict__ levels,
                     T* __restrict__ out, int R, int C, int P, int ratio, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Taps t = carve(smem, P, cap);
  const int box = blockIdx.x, py = blockIdx.y;
  const Box b = box_at(lv, boxes, levels, box, box / R, C, (int)sizeof(T));
  block_taps(b, t, py, P, C, ratio, cap, threadIdx.x, blockDim.x);
  __syncthreads();
  block_outputs<T, V>(b, t, out + ((size_t)box * P + py) * P * C, P, C, cap, threadIdx.x, blockDim.x);
}

template <typename T, int V>
cudaError_t launch(const Levels& lv, const float* boxes, const int* levels, void* out, int n_boxes, int R, int C,
                   int P, int ratio, int cap, cudaStream_t s) {
  const int work = P * (C / V);
  int threads = (work + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  roi_align_kernel<T, V><<<dim3((unsigned)n_boxes, (unsigned)P), threads, smem_bytes(P, cap), s>>>(
      lv, boxes, levels, static_cast<T*>(out), R, C, P, ratio, cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// maps: n_levels device pointers (host array), each [B, heights[l],
// widths[l], C] channel-last, all of one type (bf16 if is_bf16 else f32);
// scales[l] the level's spatial scale; boxes [B, R, 4] f32 xyxy image
// coordinates; levels [B, R] int32 level indices, or null with one level;
// out [B, R, P, P, C] of the maps' type. All contiguous, on the device;
// maps and out 16-byte aligned and C a whole number of 16-byte vectors
// (a multiple of 8 in bf16, of 4 in f32), else cudaErrorMisalignedAddress.
// ratio: sampling_ratio (0 adaptive). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int roi_align_forward(const void* const* maps, const int* heights, const int* widths, const float* scales,
                                 int n_levels, int is_bf16, const void* boxes, const void* levels, void* out, int B,
                                 int R, int C, int P, int ratio, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || (n_levels > 1 && !levels) || B <= 0 || R <= 0 || C <= 0 || P <= 0 ||
      P > 65535 || ratio < 0 || ratio > 64 || (long long)B * R > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  lv.n = n_levels;
  bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int l = 0; l < n_levels; ++l) {
    if (heights[l] <= 0 || widths[l] <= 0 || (long long)heights[l] * widths[l] * C > 0x7fffffffll)
      return static_cast<int>(cudaErrorInvalidValue);
    lv.map[l] = maps[l];
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.scale[l] = scales[l];
    aligned = aligned && (reinterpret_cast<uintptr_t>(maps[l]) & 15) == 0;
  }
  const int cap = 2 * (ratio > ADAPTIVE_S_MAX ? ratio : ADAPTIVE_S_MAX);
  if (smem_bytes(P, cap) > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const float* fb = static_cast<const float*>(boxes);
  const int* lvl = static_cast<const int*>(levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!aligned || C % (is_bf16 ? 8 : 4) != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const int n = B * R;
  if (is_bf16) return static_cast<int>(launch<__nv_bfloat16, 8>(lv, fb, lvl, out, n, R, C, P, ratio, cap, s));
  return static_cast<int>(launch<float, 4>(lv, fb, lvl, out, n, R, C, P, ratio, cap, s));
}

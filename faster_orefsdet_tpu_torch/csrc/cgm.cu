// Fused CGM correlation + conv3 projection for one pyramid level, the whole
// batch in one launch.
//
// Replaces the JAX package's Pallas TPU kernel
// faster_orefsdet_tpu/ops/pallas_cgm.py::_cgm_kernel. Per pixel, with
// q [B,H,W,C] (the channels-last memory of an NCHW map), any C >= 1:
//
//   c2   = relu(relu(q * k1) * k1)
//   d1   = relu(stencil_w(q, k13))          3 taps along W, zero padded
//   d2   = relu(stencil_h(d1, k31))         3 taps along H, zero padded
//   attn = c2 + d2 + q
//   out  = relu([attn | q] . W3^T + b3)     W3 = nn.Linear's weight [C, 2C]
//
// q may be bf16 or f32 and is widened on load, which is exact; the stencil
// chain is f32; out is bf16 or f32, rounded once from the f32 result.
//
// What bounds it on the card: per output value it reads and writes a few
// bytes and does 2*2C projection operations plus 15 elementwise ones. On the
// tensor cores (TF32, 495 TFLOP/s) the projection still outweighs the bytes
// at 3.35 TB/s, so operations bound it.
//
// Design: the 256-deep projection runs on the tensor cores with
// mma.sync.m16n8k8 TF32 in split precision ("3xTF32"): each f32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), and hi*lo + lo*hi + hi*hi
// is summed in f32, which keeps the result near the f32 sum (one TF32
// product alone keeps three digits); the q half of a bf16 input is TF32
// already and needs two products. W3 is staged once per block in shared
// memory with cp.async, as stored (K-major, so it is the mma's column-major
// B without a transpose). The grid is persistent, one block per SM, and each
// block walks tiles of 32 pixels of the flattened B*H*W (16 where that
// leaves each block one tile, as for batch 1's p4 and p5). Phase 1 builds a
// tile's [attn | q] in shared memory, each thread owning four channels (its
// taps stay in registers); the H stencil reads the post-relu d1 of the rows
// above and below, so d1 is evaluated on three rows. Its nine loads a value
// wait on L2, so 8 producer warps run phase 1 of the block's next tile into
// a second buffer while 4 warps, each the tile's pixels x 32 channels, run
// the current tile's products. The k order inside each 16-deep step is
// permuted alike for A and B, so that a thread's fragments are one 16-byte
// load. Epilogue: + b3, relu, round once to the output type.
//
// What bounds this design: at batch 8 the mma.sync rate of the three
// products (wgmma would be faster, but needs W3's hi and lo, 256 KB, in
// shared memory); at batch 1 the chain of one block: W3's 128 KB into shared
// memory, one phase 1, the products of one tile.
//
// Other widths (C != 128, as DLA-34 + BiFPN's 160) run cgm_any_kernel, a
// simpler kernel on the same 3xTF32 products: a grid of (32-pixel tiles,
// 256-channel slices of the output), 8 warps a block, each half of the
// depth padded with zeros to whole 32-deep slabs. For each slab the block
// builds its [attn | q] columns from q (scalar loads; attn's stencils are
// evaluated per value) while the matching 256 x 32 piece of W3 lands by
// cp.async, both in shared memory, then runs the products. Shared memory
// does not grow with C; above 256 channels attn is computed once per
// output slice.
//
// Changed from the first port of this kernel: that one ran the projection as
// f32 FMAs on the CUDA cores, one output channel per thread, each step
// waiting on an L2 load of W3, on a grid of (W/32, H, B) blocks (10 blocks
// for a batch-1 p5), and wrote f32 for a separate cast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include <type_traits>

namespace {

constexpr int MAX_DEVICES = 64;

// Opt `kernel` into `smem` bytes of dynamic shared memory on the current
// device. The attribute holds for one device, so it is set on each device's
// first call (which is never captured into a graph: the callers warm up).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem, std::atomic<bool> (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev].load()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    done[dev].store(true);
  }
  return cudaSuccess;
}

constexpr int C = 128;
constexpr int DEPTH = 2 * C;        // projection depth
constexpr int MMA_WARPS = 4;        // 32 channels each, all of a tile's pixels
constexpr int PRODUCER_WARPS = 8;   // phase 1 of the next tile
constexpr int THREADS = 32 * (MMA_WARPS + PRODUCER_WARPS);
constexpr int STRIDE = DEPTH + 16;  // floats per shared row: conflict-free 16-byte fragment loads

// four channels of q as loaded (8 bytes of bf16, 16 of f32), widened to f32
// only where used, which keeps phase 1's loads in flight in fewer registers
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// x = hi + lo + (a rest of about 2^-22 |x|), hi and lo TF32, each rounded
// to nearest (ties away from zero) by adding half a TF32 ulp to the
// magnitude bits and clearing the 13 bits TF32 drops: four integer
// operations and a subtraction, where cvt.rna.tf32.f32 takes nine. x is
// finite.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mi][ni] += A[16 rows of m tile mi, k0:k1] . B[k0:k1, 8 columns of n
// tile ni] in 3xTF32 (2 products where A_LO is false: A holds TF32 values
// already). arow / brow point at the thread's first A row / B column, k =
// 4*t4. Within each 16-deep step a thread loads k = 4*t4 .. 4*t4+3 of its
// rows; mma step 0 takes the first two of them as logical k = t4 and t4 + 4,
// step 1 the last two, for A and B alike. Consecutive mma go to different
// accumulators, so that one's latency hides behind the others.
template <int MT, bool A_LO, int S = STRIDE>
__device__ __forceinline__ void project(float (&acc)[MT][4][4], const float* arow,
                                        const float* brow, int k0, int k1) {
#pragma unroll 2
  for (int kk = k0; kk < k1; kk += 16) {
    unsigned ah[MT][2][4], al[MT][2][4], bh[4][4], bl[4][4];  // [tile][step or k][reg]
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const float4 r0 = *reinterpret_cast<const float4*>(arow + (mi * 16) * S + kk);
      const float4 r1 = *reinterpret_cast<const float4*>(arow + (mi * 16 + 8) * S + kk);
      const float v[2][4] = {{r0.x, r1.x, r0.y, r1.y}, {r0.z, r1.z, r0.w, r1.w}};
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (A_LO)
            split_tf32(v[s][e], ah[mi][s][e], al[mi][s][e]);
          else
            ah[mi][s][e] = __float_as_uint(v[s][e]);
        }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float4 bv = *reinterpret_cast<const float4*>(brow + (ni * 8) * S + kk);
      split_tf32(bv.x, bh[ni][0], bl[ni][0]);
      split_tf32(bv.y, bh[ni][1], bl[ni][1]);
      split_tf32(bv.z, bh[ni][2], bl[ni][2]);
      split_tf32(bv.w, bh[ni][3], bl[ni][3]);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_tf32(acc[mi][ni], ah[mi][s], bl[ni][2 * s], bl[ni][2 * s + 1]);
      if (A_LO) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(acc[mi][ni], al[mi][s], bh[ni][2 * s], bh[ni][2 * s + 1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_tf32(acc[mi][ni], ah[mi][s], bh[ni][2 * s], bh[ni][2 * s + 1]);
    }
  }
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

// Phase 1 for one tile: [attn | q] of pixels tile*TM + p, p = pw, pw + step,
// .., channels c4 .. c4+3, into a[p][.] (zeros past the last pixel). The
// nine loads of each of PIX pixels are issued together from clamped
// addresses (no branch between them), then the zero padding is applied.
template <int TM, typename T>
__device__ __forceinline__ void build_tile(const T* __restrict__ q, float* a, int tile, int pw,
                                           int step, int c4, int npix, int H, int W,
                                           float4 tk1, const float4 (&t13)[3], const float4 (&t31)[3]) {
  constexpr int PIX = 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p0 = pw; p0 < TM; p0 += PIX * step) {
    decltype(load4(q)) v[PIX][3][3];  // [pixel][row h-1, h, h+1][column w-1, w, w+1]
    int hw[PIX][2];
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      const int pix = min(tile * TM + p0 + i * step, npix - 1);
      const int w = pix % W;
      const int h = (pix / W) % H;
      hw[i][0] = h;
      hw[i][1] = w;
      const T* qb = q + (size_t)(pix - h * W - w) * C + c4;  // image's (0, 0)
      const int wl = max(w - 1, 0), wr = min(w + 1, W - 1);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T* row = qb + (size_t)min(max(h + r - 1, 0), H - 1) * W * C;
        v[i][r][0] = load4(row + (size_t)wl * C);
        v[i][r][1] = load4(row + (size_t)w * C);
        v[i][r][2] = load4(row + (size_t)wr * C);
      }
    }
#pragma unroll
    for (int i = 0; i < PIX; ++i) {
      const int p = p0 + i * step;
      if (p >= TM) break;
      const int h = hw[i][0], w = hw[i][1];
      float4 attn = zero, qc = zero;
      if (tile * TM + p < npix) {
        qc = widen(v[i][1][1]);
        float4 d2 = zero;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          if (h + r - 1 < 0 || h + r - 1 >= H) continue;
          const float4 left = w > 0 ? widen(v[i][r][0]) : zero;
          const float4 mid = widen(v[i][r][1]);
          const float4 right = w + 1 < W ? widen(v[i][r][2]) : zero;
          const float4 d1 = relu4(make_float4(left.x * t13[0].x + mid.x * t13[1].x + right.x * t13[2].x,
                                              left.y * t13[0].y + mid.y * t13[1].y + right.y * t13[2].y,
                                              left.z * t13[0].z + mid.z * t13[1].z + right.z * t13[2].z,
                                              left.w * t13[0].w + mid.w * t13[1].w + right.w * t13[2].w));
          d2.x += d1.x * t31[r].x;
          d2.y += d1.y * t31[r].y;
          d2.z += d1.z * t31[r].z;
          d2.w += d1.w * t31[r].w;
        }
        d2 = relu4(d2);
        const float4 c2 = relu4(make_float4(fmaxf(qc.x * tk1.x, 0.f) * tk1.x, fmaxf(qc.y * tk1.y, 0.f) * tk1.y,
                                            fmaxf(qc.z * tk1.z, 0.f) * tk1.z, fmaxf(qc.w * tk1.w, 0.f) * tk1.w));
        attn = make_float4(c2.x + d2.x + qc.x, c2.y + d2.y + qc.y, c2.z + d2.z + qc.z, c2.w + d2.w + qc.w);
      }
      *reinterpret_cast<float4*>(a + p * STRIDE + c4) = attn;
      *reinterpret_cast<float4*>(a + p * STRIDE + C + c4) = qc;
    }
  }
}

// MT: m16 tiles per MMA warp; a tile is TM = 16 * MT pixels
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS, 1)
cgm_kernel(const T* __restrict__ q, const float* __restrict__ k1,
           const float* __restrict__ k13, const float* __restrict__ k31,
           const float* __restrict__ w3, const float* __restrict__ b3,
           void* __restrict__ out, int out_bf16, int B, int H, int W) {
  constexpr int TM = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                  // [C][STRIDE]: W3 rows, k contiguous
  float* as = smem + C * STRIDE;     // 2 x [TM][STRIDE]: [attn | q] per pixel

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool producer = warp >= MMA_WARPS;
  const int npix = B * H * W;
  const int tiles = (npix + TM - 1) / TM;

  // W3 into shared memory, once per block; it lands while the first tile's
  // phase 1 runs
  for (int idx = tid; idx < C * (DEPTH / 4); idx += THREADS) {
    const int row = idx / (DEPTH / 4);
    const int col = 4 * (idx % (DEPTH / 4));
    cp_async16(ws + row * STRIDE + col, w3 + row * DEPTH + col);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // phase 1: channels 4*lane .. 4*lane+3, the taps in registers
  const int c4 = 4 * lane;
  const float4 tk1 = load4(k1 + c4);
  const float4 t13[3] = {load4(k13 + c4), load4(k13 + C + c4), load4(k13 + 2 * C + c4)};
  const float4 t31[3] = {load4(k31 + c4), load4(k31 + C + c4), load4(k31 + 2 * C + c4)};

  // phase 2: MMA warp wn owns the tile's pixels and channels 32*wn .. 32*wn+31
  const int wn = warp & 3;
  const int g = lane >> 2;   // mma group: row (A, C) / column (B)
  const int t4 = lane & 3;   // thread in group: k pair (A, B) / column pair (C)
  float2 bias[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
    bias[ni] = __ldg(reinterpret_cast<const float2*>(b3 + wn * 32 + ni * 8 + 2 * t4));

  // the first tile's phase 1, by every warp
  if (blockIdx.x < tiles)
    build_tile<TM>(q, as, blockIdx.x, warp, THREADS / 32, c4, npix, H, W, tk1, t13, t31);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    if (producer) {
      // ---- phase 1 of the block's next tile into the other buffer
      const int next = tile + gridDim.x;
      if (next < tiles)
        build_tile<TM>(q, as + (buf ^ 1) * TM * STRIDE, next, warp - MMA_WARPS,
                   PRODUCER_WARPS, c4, npix, H, W, tk1, t13, t31);
    } else {
      // ---- phase 2: the projection; attn (k < C) is f32 and needs its lo
      // part, q (k >= C) only when it came in as f32: a bf16 value is a TF32
      // value, so its lo part is 0
      float acc[MT][4][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      const float* arow = as + buf * TM * STRIDE + g * STRIDE + 4 * t4;
      const float* brow = ws + (wn * 32 + g) * STRIDE + 4 * t4;
      project<MT, true>(acc, arow, brow, 0, C);
      project<MT, !std::is_same<T, __nv_bfloat16>::value>(acc, arow, brow, C, DEPTH);

      // ---- epilogue: + b3, relu, round once to the output type
#pragma unroll
      for (int mh = 0; mh < 2 * MT; ++mh) {  // m tile mh / 2, rows g or g + 8
        const int pix = tile * TM + mh * 8 + g;
        if (pix >= npix) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int o = wn * 32 + ni * 8 + 2 * t4;
          const float v0 = fmaxf(acc[mh / 2][ni][2 * (mh % 2)] + bias[ni].x, 0.f);
          const float v1 = fmaxf(acc[mh / 2][ni][2 * (mh % 2) + 1] + bias[ni].y, 0.f);
          const size_t at = (size_t)pix * C + o;
          if (out_bf16)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(v0, v1);
        }
      }
    }
    __syncthreads();  // the next tile's [attn | q] is in; this one's is free
  }
}

template <typename T, int MT>
cudaError_t launch(const T* q, const float* k1, const float* k13, const float* k31,
                   const float* w3, const float* b3, void* out, int out_bf16,
                   int B, int H, int W, int sms, cudaStream_t s) {
  constexpr int TM = 16 * MT;
  constexpr size_t smem = sizeof(float) * (C + 2 * TM) * STRIDE;
  static std::atomic<bool> opted[MAX_DEVICES];
  const cudaError_t attr = opt_in_smem(cgm_kernel<T, MT>, smem, opted);
  if (attr != cudaSuccess) return attr;
  const int tiles = (B * H * W + TM - 1) / TM;
  cgm_kernel<T, MT><<<tiles < sms ? tiles : sms, THREADS, smem, s>>>(
      q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W);
  return cudaGetLastError();
}

// 16-pixel tiles where each block then has one tile (a short chain for
// batch 1's small levels), else 32-pixel tiles (fewer B fragments a product)
template <typename T>
cudaError_t dispatch(const T* q, const float* k1, const float* k13, const float* k31,
                     const float* w3, const float* b3, void* out, int out_bf16,
                     int B, int H, int W, int sms, cudaStream_t s) {
  if ((B * H * W + 15) / 16 > sms)
    return launch<T, 2>(q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, sms, s);
  return launch<T, 1>(q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, sms, s);
}

// ---- any C

constexpr int ANY_K = 32;              // depth of a slab
constexpr int ANY_STRIDE = ANY_K + 16; // floats per shared row: conflict-free fragment loads
constexpr int ANY_WARPS = 8;           // 32 output channels each
constexpr int ANY_N = 32 * ANY_WARPS;  // output channels of a block
constexpr int ANY_MT = 2;              // m16 tiles: 32 pixels a tile
constexpr int ANY_TM = 16 * ANY_MT;
constexpr int ANY_THREADS = 32 * ANY_WARPS;
constexpr size_t ANY_SMEM = sizeof(float) * (ANY_TM + ANY_N) * ANY_STRIDE;

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

// 4 bytes from gmem into smem, or 4 zero bytes when `full` is false
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// attn = c2 + d2 + q of channel ch at pixel pix of the flattened B*H*W; the
// nine loads are issued together from clamped addresses, then the zero
// padding is applied
template <typename T>
__device__ __forceinline__ float attn_at(const T* __restrict__ q, const float* __restrict__ k1,
                                         const float* __restrict__ k13, const float* __restrict__ k31,
                                         int pix, int ch, int C, int H, int W) {
  const int w = pix % W;
  const int h = (pix / W) % H;
  const T* img = q + (size_t)(pix - h * W - w) * C + ch;  // the image's (0, 0)
  const int wl = max(w - 1, 0), wr = min(w + 1, W - 1);
  float v[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T* row = img + (size_t)min(max(h + r - 1, 0), H - 1) * W * C;
    v[r][0] = load1(row + (size_t)wl * C);
    v[r][1] = load1(row + (size_t)w * C);
    v[r][2] = load1(row + (size_t)wr * C);
  }
  const float t0 = __ldg(k13 + ch), t1 = __ldg(k13 + C + ch), t2 = __ldg(k13 + 2 * C + ch);
  float d2 = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (h + r - 1 < 0 || h + r - 1 >= H) continue;
    const float left = w > 0 ? v[r][0] : 0.f;
    const float right = w + 1 < W ? v[r][2] : 0.f;
    d2 += fmaxf(left * t0 + v[r][1] * t1 + right * t2, 0.f) * __ldg(k31 + r * C + ch);
  }
  const float qc = v[1][1];
  const float tk = __ldg(k1 + ch);
  return fmaxf(fmaxf(qc * tk, 0.f) * tk, 0.f) + fmaxf(d2, 0.f) + qc;
}

// grid (tiles of ANY_TM pixels, ceil(C / ANY_N)); warp wn owns output
// channels blockIdx.y * ANY_N + 32*wn .. +31 of the tile's pixels (a warp
// past C only stages)
template <typename T>
__global__ void __launch_bounds__(ANY_THREADS)
cgm_any_kernel(const T* __restrict__ q, const float* __restrict__ k1,
               const float* __restrict__ k13, const float* __restrict__ k31,
               const float* __restrict__ w3, const float* __restrict__ b3,
               void* __restrict__ out, int out_bf16, int B, int H, int W, int C) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                         // [ANY_TM][ANY_STRIDE]: [attn | q] columns of the slab
  float* bs = smem + ANY_TM * ANY_STRIDE;   // [ANY_N][ANY_STRIDE]: W3 rows of the slice, the slab's columns

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int npix = B * H * W;
  const int p0 = blockIdx.x * ANY_TM;
  const int n0 = blockIdx.y * ANY_N;
  const int cp = (C + ANY_K - 1) / ANY_K * ANY_K;  // each half of the depth, padded to whole slabs
  const bool mma_warp = n0 + 32 * wn < C;

  float acc[ANY_MT][4][4];
#pragma unroll
  for (int mi = 0; mi < ANY_MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < 2 * cp; k0 += ANY_K) {
    const bool attn_half = k0 < cp;
    const int c0 = attn_half ? k0 : k0 - cp;  // the slab's first channel
    // the W3 piece by 4-byte cp.async (any C, so any alignment; zero-filled
    // past C), in flight while attn is computed
    const int col0 = attn_half ? c0 : C + c0;  // W3's column of the slab's first channel
    for (int e = tid; e < ANY_N * ANY_K; e += ANY_THREADS) {
      const int o = e / ANY_K, kk = e % ANY_K;
      const bool in = n0 + o < C && c0 + kk < C;
      cp_async4_zfill(bs + o * ANY_STRIDE + kk, w3 + (in ? (size_t)(n0 + o) * 2 * C + col0 + kk : 0), in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll 4
    for (int e = tid; e < ANY_TM * ANY_K; e += ANY_THREADS) {
      const int p = e / ANY_K, kk = e % ANY_K;
      const int pix = p0 + p, ch = c0 + kk;
      float v = 0.f;
      if (pix < npix && ch < C)
        v = attn_half ? attn_at(q, k1, k13, k31, pix, ch, C, H, W) : load1(q + (size_t)pix * C + ch);
      as[p * ANY_STRIDE + kk] = v;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const float* arow = as + g * ANY_STRIDE + 4 * t4;
    const float* brow = bs + (wn * 32 + g) * ANY_STRIDE + 4 * t4;
    // attn needs its lo part; q only when it came in as f32
    if (mma_warp) {
      if (attn_half || !std::is_same<T, __nv_bfloat16>::value)
        project<ANY_MT, true, ANY_STRIDE>(acc, arow, brow, 0, ANY_K);
      else
        project<ANY_MT, false, ANY_STRIDE>(acc, arow, brow, 0, ANY_K);
    }
    __syncthreads();
  }

  // epilogue: + b3, relu, round once to the output type
#pragma unroll
  for (int mh = 0; mh < 2 * ANY_MT; ++mh) {
    const int pix = p0 + mh * 8 + g;
    if (pix >= npix) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = n0 + wn * 32 + ni * 8 + 2 * t4 + e;
        if (o >= C) continue;
        const float v = fmaxf(acc[mh / 2][ni][2 * (mh % 2) + e] + __ldg(b3 + o), 0.f);
        const size_t at = (size_t)pix * C + o;
        if (out_bf16)
          static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(v);
        else
          static_cast<float*>(out)[at] = v;
      }
    }
  }
}

template <typename T>
cudaError_t launch_any(const T* q, const float* k1, const float* k13, const float* k31,
                       const float* w3, const float* b3, void* out, int out_bf16,
                       int B, int H, int W, int C, cudaStream_t s) {
  static std::atomic<bool> opted[MAX_DEVICES];
  const cudaError_t attr = opt_in_smem(cgm_any_kernel<T>, ANY_SMEM, opted);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((B * H * W + ANY_TM - 1) / ANY_TM, (C + ANY_N - 1) / ANY_N);
  cgm_any_kernel<T><<<grid, ANY_THREADS, ANY_SMEM, s>>>(q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, C);
  return cudaGetLastError();
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B,H,W,C] (bf16 if q_is_bf16 else f32), C = `channels` (the tuned
// kernel at 128, cgm_any_kernel at any other); k1 [C]; k13, k31 [3,C];
// w3 [C,2C] (nn.Linear's weight, columns [attn; q]); b3 [C]; out [B,H,W,C]
// (bf16 if out_bf16 else f32). All contiguous and 16-byte aligned, on the
// device. Launches on `stream` and returns cudaGetLastError().
extern "C" int cgm_forward(const void* q, int q_is_bf16, const void* k1,
                           const void* k13, const void* k31, const void* w3,
                           const void* b3, void* out, int out_bf16, int B, int H,
                           int W, int channels, void* stream) {
  const int sms = sm_count();  // of the current device
  if (channels <= 0 || channels > 65535 * ANY_N || B <= 0 || H <= 0 || W <= 0 ||
      (long long)B * H * W > (1ll << 30) || (long long)B * H * W * channels > (1ll << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fk1 = static_cast<const float*>(k1);
  const float* fk13 = static_cast<const float*>(k13);
  const float* fk31 = static_cast<const float*>(k31);
  const float* fw3 = static_cast<const float*>(w3);
  const float* fb3 = static_cast<const float*>(b3);
  const __nv_bfloat16* qh = static_cast<const __nv_bfloat16*>(q);
  const float* qf = static_cast<const float*>(q);
  cudaError_t err;
  if (channels != C)
    err = q_is_bf16 ? launch_any(qh, fk1, fk13, fk31, fw3, fb3, out, out_bf16, B, H, W, channels, s)
                    : launch_any(qf, fk1, fk13, fk31, fw3, fb3, out, out_bf16, B, H, W, channels, s);
  else
    err = q_is_bf16 ? dispatch(qh, fk1, fk13, fk31, fw3, fb3, out, out_bf16, B, H, W, sms, s)
                    : dispatch(qf, fk1, fk13, fk31, fw3, fb3, out, out_bf16, B, H, W, sms, s);
  return static_cast<int>(err);
}

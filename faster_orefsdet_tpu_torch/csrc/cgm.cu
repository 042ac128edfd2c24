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
// The taps may come as n_cls sets (one per class of a multiclass request,
// the counterpart of the JAX package's vmapped Pallas call): q is shared,
// the output is [n_cls*B,H,W,C], class-major, and the persistent blocks walk
// (class, tile) pairs; W3 is staged once per block for all classes, and a
// producer thread loads its taps again only where its walk enters another
// class.
//
// Other widths (C != 128, as DLA-34 + BiFPN's 160) run cgm_slice_kernel, the
// same plan cut to width: each half of the depth padded with zeros to cp = C
// rounded up to 16, the output channels cut into slices of at most 80 (16
// per n8 tile pair) so that a block's slice of W3 and two [attn | q] tiles
// of 32 pixels fit in shared memory together (at C = 160: two slices of 80,
// 189 KB). The grid is persistent; a block owns one slice, stages it once
// with 16-byte cp.async, and walks (class, tile) pairs, 8 producer warps
// building the next tile (a thread holds one group of four channels and
// its taps, and issues the loads of two pixels together) while 4 MMA
// warps, 2 x 2 over the tile's two m16 tiles and the slice's two halves,
// run the current one's 3xTF32 products; all four MMA warps are busy at
// every width. Where even one slice of 16 does not fit (C > 352) the depth
// is streamed in 64-deep chunks, W3's piece of each chunk staged beside its
// [attn | q] piece. Widths that are not a multiple of 4 take scalar loads
// and 4-byte copies.
//
// What bounds this design at C = 160: the issue of both warp roles, each
// about as long as the whole when the other is cut out: the MMA warps split
// every B fragment for one m16 tile (the tuned kernel's serve two), and the
// stencil is evaluated once per slice, twice a pixel.
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
template <int MT, bool A_LO>
__device__ __forceinline__ void project(float (&acc)[MT][4][4], const float* arow,
                                        const float* brow, int k0, int k1) {
#pragma unroll 2
  for (int kk = k0; kk < k1; kk += 16) {
    unsigned ah[MT][2][4], al[MT][2][4], bh[4][4], bl[4][4];  // [tile][step or k][reg]
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const float4 r0 = *reinterpret_cast<const float4*>(arow + (mi * 16) * STRIDE + kk);
      const float4 r1 = *reinterpret_cast<const float4*>(arow + (mi * 16 + 8) * STRIDE + kk);
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
      const float4 bv = *reinterpret_cast<const float4*>(brow + (ni * 8) * STRIDE + kk);
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

// the taps of class `cls` for channels c4 .. c4+3: k1 [n_cls, C], k13 and
// k31 [n_cls, 3, C]
__device__ __forceinline__ void load_taps(const float* __restrict__ k1, const float* __restrict__ k13,
                                          const float* __restrict__ k31, int cls, int c4, float4& tk1,
                                          float4 (&t13)[3], float4 (&t31)[3]) {
  tk1 = load4(k1 + cls * C + c4);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    t13[r] = load4(k13 + (cls * 3 + r) * C + c4);
    t31[r] = load4(k31 + (cls * 3 + r) * C + c4);
  }
}

// MT: m16 tiles per MMA warp; a tile is TM = 16 * MT pixels
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS, 1)
cgm_kernel(const T* __restrict__ q, const float* __restrict__ k1,
           const float* __restrict__ k13, const float* __restrict__ k31,
           const float* __restrict__ w3, const float* __restrict__ b3,
           void* __restrict__ out, int out_bf16, int B, int H, int W, int n_cls) {
  constexpr int TM = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                  // [C][STRIDE]: W3 rows, k contiguous
  float* as = smem + C * STRIDE;     // 2 x [TM][STRIDE]: [attn | q] per pixel

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool producer = warp >= MMA_WARPS;
  const int npix = B * H * W;
  const int tiles = (npix + TM - 1) / TM;  // of one class
  const int work = n_cls * tiles;          // (class, tile) pairs, class-major

  // W3 into shared memory, once per block; it lands while the first tile's
  // phase 1 runs
  for (int idx = tid; idx < C * (DEPTH / 4); idx += THREADS) {
    const int row = idx / (DEPTH / 4);
    const int col = 4 * (idx % (DEPTH / 4));
    cp_async16(ws + row * STRIDE + col, w3 + row * DEPTH + col);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // phase 1: channels 4*lane .. 4*lane+3, the taps of the tile's class in
  // registers (loaded again only where the walk enters another class)
  const int c4 = 4 * lane;
  int cls = min(blockIdx.x, work - 1) / tiles;
  float4 tk1, t13[3], t31[3];
  load_taps(k1, k13, k31, cls, c4, tk1, t13, t31);

  // phase 2: MMA warp wn owns the tile's pixels and channels 32*wn .. 32*wn+31
  const int wn = warp & 3;
  const int g = lane >> 2;   // mma group: row (A, C) / column (B)
  const int t4 = lane & 3;   // thread in group: k pair (A, B) / column pair (C)
  float2 bias[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
    bias[ni] = __ldg(reinterpret_cast<const float2*>(b3 + wn * 32 + ni * 8 + 2 * t4));

  // the first tile's phase 1, by every warp
  if (blockIdx.x < work)
    build_tile<TM>(q, as, blockIdx.x % tiles, warp, THREADS / 32, c4, npix, H, W, tk1, t13, t31);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  int buf = 0;
  for (int item = blockIdx.x; item < work; item += gridDim.x, buf ^= 1) {
    const int tile = item % tiles;
    if (producer) {
      // ---- phase 1 of the block's next tile into the other buffer
      const int next = item + gridDim.x;
      if (next < work) {
        if (next / tiles != cls) {
          cls = next / tiles;
          load_taps(k1, k13, k31, cls, c4, tk1, t13, t31);
        }
        build_tile<TM>(q, as + (buf ^ 1) * TM * STRIDE, next % tiles, warp - MMA_WARPS,
                       PRODUCER_WARPS, c4, npix, H, W, tk1, t13, t31);
      }
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
          const size_t at = ((size_t)(item / tiles) * npix + pix) * C + o;  // row class * npix + pix
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
                   int B, int H, int W, int n_cls, int sms, cudaStream_t s) {
  constexpr int TM = 16 * MT;
  constexpr size_t smem = sizeof(float) * (C + 2 * TM) * STRIDE;
  static std::atomic<bool> opted[MAX_DEVICES];
  const cudaError_t attr = opt_in_smem(cgm_kernel<T, MT>, smem, opted);
  if (attr != cudaSuccess) return attr;
  const long long work = (long long)n_cls * ((B * H * W + TM - 1) / TM);
  cgm_kernel<T, MT><<<work < sms ? (int)work : sms, THREADS, smem, s>>>(
      q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, n_cls);
  return cudaGetLastError();
}

// 16-pixel tiles where each block then has one tile (a short chain for
// batch 1's small levels), else 32-pixel tiles (fewer B fragments a product)
template <typename T>
cudaError_t dispatch(const T* q, const float* k1, const float* k13, const float* k31,
                     const float* w3, const float* b3, void* out, int out_bf16,
                     int B, int H, int W, int n_cls, int sms, cudaStream_t s) {
  if ((long long)n_cls * ((B * H * W + 15) / 16) > sms)
    return launch<T, 2>(q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, n_cls, sms, s);
  return launch<T, 1>(q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, n_cls, sms, s);
}

// ---- any C: cgm_slice_kernel

constexpr int SL_TM = 32;              // pixels a tile: two m16 tiles
constexpr int SL_MMA_WARPS = 4;        // 2 (m16 tile) x 2 (half of the slice's channels)
constexpr int SL_PRODUCER_WARPS = 8;   // phase 1 of the next stage
constexpr int SL_PIX = 2;              // pixels whose loads a producer thread issues together
constexpr int SL_THREADS = 32 * (SL_MMA_WARPS + SL_PRODUCER_WARPS);
constexpr int SL_KC = 64;              // depth of a streamed chunk
constexpr int SL_MAX_NTW = 5;          // n8 tiles of an MMA warp: a slice is at most 80 channels
constexpr size_t SL_SMEM_MAX = 232448; // the dynamic shared memory a block may opt into

// How a width C runs. Resident: [attn | q] of a tile over the whole depth
// 2*cp (each half padded with zeros to cp = C rounded up to 16) and the
// block's slice of W3 (16*ntw output channels, all of the depth) fit in
// shared memory together, so the slice is staged once per block and each
// stage is one tile. Streamed (C > 352): stages are (tile, 64-deep chunk)
// pairs and W3's piece of each chunk is staged with it.
struct SlicePlan {
  int cp, kc, stride, ntw, nslices;
  size_t smem;
};

SlicePlan plan_slices(int C) {
  SlicePlan p;
  const int c16 = (C + 15) / 16;  // output channels in units of 16
  p.cp = 16 * c16;
  p.stride = 2 * p.cp + 16;       // floats a shared row: 16 mod 32, conflict-free fragment loads
  const long long fit = ((long long)(SL_SMEM_MAX / (sizeof(float) * p.stride)) - 2 * SL_TM) / 16;
  const bool resident = fit >= 1;
  if (!resident) {
    p.cp = (C + SL_KC - 1) / SL_KC * SL_KC;
    p.stride = SL_KC + 16;
  }
  const int most = resident ? (int)(fit < SL_MAX_NTW ? fit : SL_MAX_NTW) : SL_MAX_NTW;
  p.nslices = (c16 + most - 1) / most;
  p.ntw = (c16 + p.nslices - 1) / p.nslices;  // the slices as even as whole n8 tile pairs allow
  p.kc = resident ? 2 * p.cp : SL_KC;
  p.smem = sizeof(float) * p.stride * (2 * SL_TM + (resident ? 1 : 2) * 16 * p.ntw);
  return p;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// 16 (or 4) bytes from gmem into smem, or zeros when `full` is false
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(full ? 4 : 0)
               : "memory");
}

// attn of channel ch at pixel pix (scalar: C not a multiple of 4)
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

// attn of channels c0 .. c0+nch-1 (nch a multiple of 16; zeros past C and
// past the last pixel) of the tile's pixels into columns col0 .. of a's
// rows, by threads t of nt. Vector path (C a multiple of 4): thread t takes
// the 4 channels of group t % G (G = nch / 4) at pixels t / G, + nt / G, ..,
// with its taps in registers; the 9 loads of each of SL_PIX pixels are
// issued together from clamped addresses, as build_tile does.
template <typename T>
__device__ __forceinline__ void slice_attn(const T* __restrict__ q, const float* __restrict__ k1,
                                           const float* __restrict__ k13, const float* __restrict__ k31,
                                           float* a, int S, int col0, int c0, int nch, int tile, int npix,
                                           int H, int W, int C, int t, int nt) {
  const int G = nch >> 2;
  if ((C & 3) == 0) {
    constexpr int PIX = SL_PIX;
    const int lanes = nt / G;  // pixel lanes; threads past lanes * G idle
    if (t >= lanes * G) return;
    const int ch = c0 + 4 * (t % G);
    const int chc = min(ch, C - 4);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 tk1 = load4(k1 + chc);
    const float4 t13[3] = {load4(k13 + chc), load4(k13 + C + chc), load4(k13 + 2 * C + chc)};
    const float4 t31[3] = {load4(k31 + chc), load4(k31 + C + chc), load4(k31 + 2 * C + chc)};
    for (int p0 = t / G; p0 < SL_TM; p0 += PIX * lanes) {
      decltype(load4(q)) v[PIX][3][3];
      int hw[PIX][2];
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        const int pix = min(tile * SL_TM + min(p0 + i * lanes, SL_TM - 1), npix - 1);
        const int w = pix % W;
        const int h = (pix / W) % H;
        hw[i][0] = h;
        hw[i][1] = w;
        const T* qb = q + (size_t)(pix - h * W - w) * C + chc;
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
        const int p = p0 + i * lanes;
        if (p >= SL_TM) break;
        const int h = hw[i][0], w = hw[i][1];
        float4 attn = zero;
        if (tile * SL_TM + p < npix && ch < C) {
          const float4 qc = widen(v[i][1][1]);
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
        *reinterpret_cast<float4*>(a + p * S + col0 + (ch - c0)) = attn;
      }
    }
  } else {
    for (int e = t; e < SL_TM * G; e += nt) {
      const int p = e / G;
      const int ch = c0 + 4 * (e % G);
      const int pix = tile * SL_TM + p;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[p * S + col0 + (ch - c0) + j] =
            pix < npix && ch + j < C ? attn_at(q, k1, k13, k31, pix, ch + j, C, H, W) : 0.f;
    }
  }
}

// q's channels c0 .. c0+nch-1 (zeros past C and past the last pixel) of the
// tile's pixels, widened, into columns col0 .. of a's rows
template <typename T>
__device__ __forceinline__ void slice_q(const T* __restrict__ q, float* a, int S, int col0, int c0, int nch,
                                        int tile, int npix, int C, int t, int nt) {
  const int G = nch >> 2;
  const int items = SL_TM * G;
  if ((C & 3) == 0) {
#pragma unroll 4
    for (int e = t; e < items; e += nt) {
      const int p = e / G;
      const int ch = c0 + 4 * (e % G);
      const int pix = tile * SL_TM + p;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pix < npix && ch < C) v = widen(load4(q + (size_t)pix * C + ch));
      *reinterpret_cast<float4*>(a + p * S + col0 + (ch - c0)) = v;
    }
  } else {
    for (int e = t; e < items; e += nt) {
      const int p = e / G;
      const int ch = c0 + 4 * (e % G);
      const int pix = tile * SL_TM + p;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[p * S + col0 + (ch - c0) + j] = pix < npix && ch + j < C ? load1(q + (size_t)pix * C + ch + j) : 0.f;
    }
  }
}

// W3's rows n0 .. n0+rows-1 at depth d0 .. d0+nd-1 (depth d < cp is attn's
// channel d, W3's column d; d >= cp is q's channel d - cp, column C + d - cp;
// zeros past C either way) into ws[row][d - d0] by cp.async, threads t of nt
__device__ __forceinline__ void slice_w3(const float* __restrict__ w3, float* ws, int S, int n0, int rows,
                                         int d0, int nd, int cp, int C, int t, int nt) {
  const int G = nd >> 2;
  for (int e = t; e < rows * G; e += nt) {
    const int r = e / G;
    const int d = d0 + 4 * (e % G);
    const int ch = d < cp ? d : d - cp;
    const int col = d < cp ? d : C + ch;
    const int o = n0 + r;
    float* dst = ws + r * S + (d - d0);
    if ((C & 3) == 0) {
      const bool in = o < C && ch < C;
      cp_async16_zfill(dst, w3 + (in ? (size_t)o * 2 * C + col : 0), in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = o < C && ch + j < C;
        cp_async4_zfill(dst + j, w3 + (in ? (size_t)o * 2 * C + col + j : 0), in);
      }
    }
  }
}

// acc[ni] += A[16 rows, k0:k1] . B[k0:k1, 8 columns of n tile ni] in 3xTF32
// (2 products where A_LO is false), as project does for one m16 tile and
// NT n8 tiles, on rows `stride` floats apart
template <int NT, bool A_LO>
__device__ __forceinline__ void project_rows(float (&acc)[NT][4], const float* arow, const float* brow,
                                             int stride, int k0, int k1) {
#pragma unroll 2
  for (int kk = k0; kk < k1; kk += 16) {
    unsigned ah[2][4], al[2][4], bh[NT][4], bl[NT][4];
    const float4 r0 = *reinterpret_cast<const float4*>(arow + kk);
    const float4 r1 = *reinterpret_cast<const float4*>(arow + 8 * stride + kk);
    const float v[2][4] = {{r0.x, r1.x, r0.y, r1.y}, {r0.z, r1.z, r0.w, r1.w}};
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (A_LO)
          split_tf32(v[s][e], ah[s][e], al[s][e]);
        else
          ah[s][e] = __float_as_uint(v[s][e]);
      }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const float4 bv = *reinterpret_cast<const float4*>(brow + (ni * 8) * stride + kk);
      split_tf32(bv.x, bh[ni][0], bl[ni][0]);
      split_tf32(bv.y, bh[ni][1], bl[ni][1]);
      split_tf32(bv.z, bh[ni][2], bl[ni][2]);
      split_tf32(bv.w, bh[ni][3], bl[ni][3]);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_tf32(acc[ni], ah[s], bl[ni][2 * s], bl[ni][2 * s + 1]);
      if (A_LO) {
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_tf32(acc[ni], al[s], bh[ni][2 * s], bh[ni][2 * s + 1]);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_tf32(acc[ni], ah[s], bh[ni][2 * s], bh[ni][2 * s + 1]);
    }
  }
}

// The grid is persistent: block b owns output slice b % nslices (16*NTW
// channels) and walks the (class, tile) pairs b / nslices, + gridDim.x /
// nslices, ..; a pair is nk stages (1 resident, 2*cp / SL_KC streamed).
// MMA warp (wm, wn) owns the tile's pixels 16*wm .. +15 and the slice's
// channels 8*NTW*wn .. +8*NTW-1; the producer warps build stage s + 1
// while the MMA warps run stage s.
template <typename T, int NTW>
__global__ void __launch_bounds__(SL_THREADS, 1)
cgm_slice_kernel(const T* __restrict__ q, const float* __restrict__ k1,
                 const float* __restrict__ k13, const float* __restrict__ k31,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 void* __restrict__ out, int out_bf16, int B, int H, int W, int C, int n_cls,
                 int cp, int kc, int S, int nslices) {
  constexpr int SN = 16 * NTW;  // output channels of a slice
  extern __shared__ __align__(16) float smem[];
  const bool resident = kc == 2 * cp;
  float* ws = smem;                                // W3's slice [SN][S], twice when streamed
  float* as = smem + (resident ? 1 : 2) * SN * S;  // 2 x [SL_TM][S]: [attn | q]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool producer = warp >= SL_MMA_WARPS;
  const int npix = B * H * W;
  const int tiles = (npix + SL_TM - 1) / SL_TM;  // of one class
  const int work = n_cls * tiles;
  const int n0 = (blockIdx.x % nslices) * SN;
  const int first = blockIdx.x / nslices;
  const int step = gridDim.x / nslices;
  if (first >= work) return;  // the whole block, before any barrier
  const int nk = 2 * cp / kc;
  const int stages = (work - first + step - 1) / step * nk;

  // stage s: pair first + (s / nk) * step, depth kc * (s % nk) ..; threads t of nt
  auto build = [&](int s, int buf, int t, int nt) {
    const int item = first + (s / nk) * step;
    const int cls = item / tiles, tile = item % tiles;
    const int d0 = kc * (s % nk);
    const float* ck1 = k1 + (size_t)cls * C;
    const float* ck13 = k13 + (size_t)cls * 3 * C;
    const float* ck31 = k31 + (size_t)cls * 3 * C;
    float* a = as + buf * SL_TM * S;
    if (!resident) {
      slice_w3(w3, ws + buf * SN * S, S, n0, SN, d0, kc, cp, C, t, nt);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (resident) {
      slice_attn(q, ck1, ck13, ck31, a, S, 0, 0, cp, tile, npix, H, W, C, t, nt);
      slice_q(q, a, S, cp, 0, cp, tile, npix, C, t, nt);
    } else if (d0 < cp) {
      slice_attn(q, ck1, ck13, ck31, a, S, 0, d0, kc, tile, npix, H, W, C, t, nt);
    } else {
      slice_q(q, a, S, 0, d0 - cp, kc, tile, npix, C, t, nt);
    }
  };

  if (resident) {  // W3's slice, once per block: it lands while the first stage is built
    slice_w3(w3, ws, S, n0, SN, 0, 2 * cp, cp, C, tid, SL_THREADS);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  build(0, 0, tid, SL_THREADS);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int wm = warp & 1, wn = (warp >> 1) & 1;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  float acc[NTW][4];
#pragma unroll
  for (int ni = 0; ni < NTW; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
  constexpr bool Q_LO = !std::is_same<T, __nv_bfloat16>::value;  // a bf16 q is TF32 already

  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (producer) {
      if (s + 1 < stages) build(s + 1, buf ^ 1, tid - 32 * SL_MMA_WARPS, 32 * SL_PRODUCER_WARPS);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    } else {
      const float* arow = as + buf * SL_TM * S + (16 * wm + g) * S + 4 * t4;
      const float* brow = ws + (resident ? 0 : buf * SN * S) + (8 * NTW * wn + g) * S + 4 * t4;
      const int d0 = kc * (s % nk);
      if (resident) {
        project_rows<NTW, true>(acc, arow, brow, S, 0, cp);
        project_rows<NTW, Q_LO>(acc, arow, brow, S, cp, 2 * cp);
      } else if (d0 < cp) {
        project_rows<NTW, true>(acc, arow, brow, S, 0, kc);
      } else {
        project_rows<NTW, Q_LO>(acc, arow, brow, S, 0, kc);
      }
      if (s % nk == nk - 1) {
        // epilogue: + b3, relu, round once to the output type; row class * npix + pix
        const int item = first + (s / nk) * step;
        const size_t row0 = (size_t)(item / tiles) * npix;
#pragma unroll
        for (int mh = 0; mh < 2; ++mh) {
          const int pix = (item % tiles) * SL_TM + 16 * wm + 8 * mh + g;
          if (pix >= npix) continue;
#pragma unroll
          for (int ni = 0; ni < NTW; ++ni) {
            const int o = n0 + 8 * (NTW * wn + ni) + 2 * t4;
            const size_t at = (row0 + pix) * C + o;
            const float v0 = o < C ? fmaxf(acc[ni][2 * mh] + __ldg(b3 + o), 0.f) : 0.f;
            const float v1 = o + 1 < C ? fmaxf(acc[ni][2 * mh + 1] + __ldg(b3 + o + 1), 0.f) : 0.f;
            if ((C & 1) == 0 && o < C) {  // o even: a pair, aligned
              if (out_bf16)
                *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) =
                    __floats2bfloat162_rn(v0, v1);
              else
                *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(v0, v1);
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (o + e >= C) continue;
                if (out_bf16)
                  static_cast<__nv_bfloat16*>(out)[at + e] = __float2bfloat16_rn(e ? v1 : v0);
                else
                  static_cast<float*>(out)[at + e] = e ? v1 : v0;
              }
            }
          }
        }
#pragma unroll
        for (int ni = 0; ni < NTW; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
      }
    }
    __syncthreads();  // stage s + 1 is in; stage s's buffers are free
  }
}

template <typename T, int NTW>
cudaError_t launch_slice_ntw(const T* q, const float* k1, const float* k13, const float* k31,
                             const float* w3, const float* b3, void* out, int out_bf16,
                             int B, int H, int W, int C, int n_cls, const SlicePlan& p, int sms, cudaStream_t s) {
  static std::atomic<bool> opted[MAX_DEVICES];
  const cudaError_t attr = opt_in_smem(cgm_slice_kernel<T, NTW>, SL_SMEM_MAX, opted);
  if (attr != cudaSuccess) return attr;
  const long long work = (long long)n_cls * ((B * H * W + SL_TM - 1) / SL_TM);
  long long per_slice = sms / p.nslices > 0 ? sms / p.nslices : 1;
  if (per_slice > work) per_slice = work;
  cgm_slice_kernel<T, NTW><<<(unsigned)(per_slice * p.nslices), SL_THREADS, p.smem, s>>>(
      q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, C, n_cls, p.cp, p.kc, p.stride, p.nslices);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_slice(const T* q, const float* k1, const float* k13, const float* k31,
                         const float* w3, const float* b3, void* out, int out_bf16,
                         int B, int H, int W, int C, int n_cls, int sms, cudaStream_t s) {
  const SlicePlan p = plan_slices(C);
  switch (p.ntw) {
    case 1: return launch_slice_ntw<T, 1>(q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, C, n_cls, p, sms, s);
    case 2: return launch_slice_ntw<T, 2>(q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, C, n_cls, p, sms, s);
    case 3: return launch_slice_ntw<T, 3>(q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, C, n_cls, p, sms, s);
    case 4: return launch_slice_ntw<T, 4>(q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, C, n_cls, p, sms, s);
    default: return launch_slice_ntw<T, 5>(q, k1, k13, k31, w3, b3, out, out_bf16, B, H, W, C, n_cls, p, sms, s);
  }
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
// kernel at 128, cgm_slice_kernel at any other); n_cls >= 1 sets of taps,
// k1 [n_cls,C], k13 and k31 [n_cls,3,C]; w3 [C,2C] (nn.Linear's weight,
// columns [attn; q]); b3 [C]; out [n_cls*B,H,W,C], class-major (bf16 if
// out_bf16 else f32). All contiguous and 16-byte aligned, on the device.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int cgm_forward(const void* q, int q_is_bf16, const void* k1,
                           const void* k13, const void* k31, const void* w3,
                           const void* b3, void* out, int out_bf16, int B, int H,
                           int W, int channels, int n_cls, void* stream) {
  const int sms = sm_count();  // of the current device
  if (channels <= 0 || channels > (1 << 20) || B <= 0 || H <= 0 || W <= 0 || n_cls <= 0 ||
      (long long)B * H * W > (1ll << 30) || (long long)n_cls * B * H * W > (1ll << 31) - 64 ||
      (long long)n_cls * B * H * W * channels > (1ll << 40))
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
    err = q_is_bf16 ? launch_slice(qh, fk1, fk13, fk31, fw3, fb3, out, out_bf16, B, H, W, channels, n_cls, sms, s)
                    : launch_slice(qf, fk1, fk13, fk31, fw3, fb3, out, out_bf16, B, H, W, channels, n_cls, sms, s);
  else
    err = q_is_bf16 ? dispatch(qh, fk1, fk13, fk31, fw3, fb3, out, out_bf16, B, H, W, n_cls, sms, s)
                    : dispatch(qf, fk1, fk13, fk31, fw3, fb3, out, out_bf16, B, H, W, n_cls, sms, s);
  return static_cast<int>(err);
}

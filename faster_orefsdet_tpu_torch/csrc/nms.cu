// Greedy NMS keep mask for a batch of fixed-K box sets, in two launches.
//
// Replaces the JAX package's Pallas TPU kernel
// faster_orefsdet_tpu/ops/pallas_nms.py::_nms_kernel, and computes the same
// mask as the plain ops/nms.py::nms_mask: rank by descending score, ties to
// the lower index; a kept box suppresses another when IoU > thr strictly;
// invalid rows neither suppress nor survive.
//
// (a) nms_mask_kernel, grid (ceil(K/64), ceil(K/64), B), 64 threads: thread
//     i of row block rb and column block cb writes the 64-bit word
//     e[b, i, cb] with bit j set when iou(i, j) > thr & valid_i & valid_j &
//     higher(i, j), and the count of valid j in the block that rank before
//     i. The rank is built by direct comparison, as nms.py does: no sort.
// (b) nms_sweep_kernel, one block per image: sums each valid box's counts
//     into its rank, scatters the boxes into rank order, and sweeps them in
//     order with the removed-set as a bitset in shared memory. Rows of e are
//     staged 64 at a time into shared memory by the whole block; one warp
//     then walks them, lane w owning word w of the bitset. The keep mask is
//     written in the original order.
//
// What bounds it on the card: it must read K*(4+1+1) values and write K
// bytes per image, so neither bytes nor the K*K IoU operations bound it at
// K <= 2048; the sweep's serial chain of dependent shared-memory steps, one
// per valid box, does. The design keeps that chain in shared memory and
// registers, with no device-memory access inside it.
//
// IoU uses round-to-nearest intrinsics in the operation order of
// structures/boxes.py::pairwise_iou, so that nvcc cannot contract a*b+c into
// an FMA and flip a borderline iou > thr against the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;     // boxes per row/column block = bits per word
constexpr int MAX_K = 2048;   // cap: order[] and the staged rows fit in shared
constexpr int MAX_WORDS = MAX_K / BLOCK;
constexpr int SWEEP_THREADS = 256;

__device__ __forceinline__ float area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

__device__ __forceinline__ bool ranks_before(float si, int i, float sj, int j) {
  return si > sj || (si == sj && i < j);
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const float* __restrict__ scores,
                                const uint8_t* __restrict__ valid, float thr,
                                int K, int words,
                                unsigned long long* __restrict__ mask,
                                int* __restrict__ rank_part) {
  __shared__ float cb_box[BLOCK][4];
  __shared__ float cb_area[BLOCK];
  __shared__ float cb_score[BLOCK];
  __shared__ uint8_t cb_valid[BLOCK];

  const int b = blockIdx.z;
  const int cb = blockIdx.x;
  const int t = threadIdx.x;
  const size_t base = (size_t)b * K;

  const int j0 = cb * BLOCK;
  if (j0 + t < K) {
    const float* bj = boxes + (base + j0 + t) * 4;
    cb_box[t][0] = bj[0];
    cb_box[t][1] = bj[1];
    cb_box[t][2] = bj[2];
    cb_box[t][3] = bj[3];
    cb_area[t] = area(bj[0], bj[1], bj[2], bj[3]);
    cb_score[t] = scores[base + j0 + t];
    cb_valid[t] = valid[base + j0 + t];
  }
  __syncthreads();

  const int i = blockIdx.y * BLOCK + t;
  if (i >= K) return;
  const float* bi = boxes + (base + i) * 4;
  const float x1 = bi[0], y1 = bi[1], x2 = bi[2], y2 = bi[3];
  const float ai = area(x1, y1, x2, y2);
  const float si = scores[base + i];
  const bool vi = valid[base + i] != 0;

  unsigned long long bits = 0ull;
  int before = 0;
  const int n = min(BLOCK, K - j0);
  for (int jj = 0; jj < n; ++jj) {
    const int j = j0 + jj;
    if (!cb_valid[jj]) continue;
    const float sj = cb_score[jj];
    if (ranks_before(sj, j, si, i)) ++before;
    if (!vi || !ranks_before(si, i, sj, j)) continue;
    const float w = fmaxf(__fsub_rn(fminf(x2, cb_box[jj][2]), fmaxf(x1, cb_box[jj][0])), 0.f);
    const float h = fmaxf(__fsub_rn(fminf(y2, cb_box[jj][3]), fmaxf(y1, cb_box[jj][1])), 0.f);
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(ai, cb_area[jj]), inter);
    const float iou = inter > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.f;
    if (iou > thr) bits |= 1ull << jj;
  }
  mask[(base + i) * words + cb] = bits;
  rank_part[(base + i) * words + cb] = before;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
nms_sweep_kernel(const uint8_t* __restrict__ valid,
                 const unsigned long long* __restrict__ mask,
                 const int* __restrict__ rank_part, int K, int words,
                 uint8_t* __restrict__ keep) {
  __shared__ int order[MAX_K];
  __shared__ unsigned long long removed[MAX_WORDS];
  __shared__ unsigned long long rows[BLOCK][MAX_WORDS];
  __shared__ int n_valid;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * K;

  for (int i = tid; i < K; i += SWEEP_THREADS) {
    order[i] = -1;
    keep[base + i] = 0;
  }
  for (int w = tid; w < words; w += SWEEP_THREADS) removed[w] = 0ull;
  if (tid == 0) n_valid = 0;
  __syncthreads();

  for (int i = tid; i < K; i += SWEEP_THREADS) {
    if (!valid[base + i]) continue;
    int r = 0;
    for (int w = 0; w < words; ++w) r += rank_part[(base + i) * words + w];
    order[r] = i;  // r < number of valid boxes <= K
    atomicAdd(&n_valid, 1);
  }
  __syncthreads();

  const int n = n_valid;
  const int lane = tid & 31;
  for (int s = 0; s < n; s += BLOCK) {
    const int m = min(BLOCK, n - s);
    for (int idx = tid; idx < m * words; idx += SWEEP_THREADS) {
      const int r = idx / words;
      const int w = idx % words;
      const int i = order[s + r];
      rows[r][w] = i >= 0 ? mask[(base + i) * words + w] : 0ull;
    }
    __syncthreads();
    if (tid < 32) {
      for (int r = 0; r < m; ++r) {
        const int i = order[s + r];
        if (i < 0) continue;
        if ((removed[i >> 6] >> (i & 63)) & 1ull) continue;
        if (lane == 0) keep[base + i] = 1;
        for (int w = lane; w < words; w += 32) removed[w] |= rows[r][w];
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// boxes [B,K,4] f32, scores [B,K] f32, valid [B,K] uint8; scratch
// mask [B,K,words] uint64 and rank_part [B,K,words] int32 with
// words = ceil(K/64); keep [B,K] uint8. All contiguous, on the device.
// Launches both kernels on `stream` and returns cudaGetLastError().
extern "C" int nms_forward(const void* boxes, const void* scores,
                           const void* valid, float thr, int B, int K,
                           void* mask, void* rank_part, void* keep,
                           void* stream) {
  if (B <= 0 || B > 65535 || K <= 0 || K > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (K + BLOCK - 1) / BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, B), BLOCK, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), thr, K, words,
      static_cast<unsigned long long*>(mask), static_cast<int*>(rank_part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<B, SWEEP_THREADS, 0, s>>>(
      static_cast<const uint8_t*>(valid),
      static_cast<const unsigned long long*>(mask),
      static_cast<const int*>(rank_part), K, words,
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}

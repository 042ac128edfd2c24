// Greedy NMS keep mask for a batch of fixed-K box sets, in three launches.
//
// Replaces the JAX package's Pallas TPU kernel
// faster_orefsdet_tpu/ops/pallas_nms.py::_nms_kernel, and computes the same
// mask as the plain ops/nms.py::nms_mask: rank by descending score, ties to
// the lower index; a kept box suppresses another when IoU > thr strictly;
// invalid rows neither suppress nor survive. Scores are taken to be numbers
// (no NaN), as the rank order needs.
//
// (a) nms_rank_kernel, grid (ceil(K/16), B), 256 threads: the rank of each
//     valid box among its image's valid boxes by direct comparison (no sort;
//     the input need not be sorted), 16 threads of a warp per box, summed by
//     shuffles; the keys pass through shared memory in tiles of 2048. Each
//     box is written to its rank in `sorted`, its rank to `rank_of` (-1 when
//     invalid); block 0 writes the image's valid count.
// (b) nms_mask_kernel, one block of 256 threads per 64x64 tile of the upper
//     triangle (grid (words*(words+1)/2, B)): word (r, c) of the row of rank
//     r has bit j set when rank 64c+j comes after r and iou > thr; 4 threads
//     build a word, 16 columns each. Tiles past the valid count return. The
//     diagonal 64x64 tile of a chunk of 64 ranks thus holds all of the
//     chunk's inner dependencies.
// (c) up to K = 2048, nms_sweep_kernel, one warp per image: the removed
//     bitset lives in registers, word w in the lanes l with l % WS == w (at
//     most 32 words; a mask row holds WS words, a power of two). For each
//     chunk c of 64 ranks the warp resolves the chunk's 64 decisions from the
//     diagonal words with register bit operations (keep rank r if it is not
//     removed, then remove what its word removes), then word w > c takes the
//     OR of word w of the kept rows, the 32 / WS lanes of a word sharing the
//     rows. The next chunk's rows are copied into shared memory with
//     cp.async (two buffers) while this one resolves. The keep mask is
//     written in the original order via rank_of.
// (c') above K = 2048, nms_sweep_wide_kernel, one block of 256 threads per
//     image: a mask row holds ceil(K/64) words, the removed and kept bitsets
//     live in shared memory (16 bytes per word), each chunk's decisions are
//     resolved as in (c) from its diagonal words (loaded one chunk ahead),
//     then the kept rows' later words are ORed into the removed bitset, one
//     (row, word) pair a thread, read straight from the mask in global
//     memory (a shared-memory atomicOr each). Its only limit is the
//     workspace, B*K*ceil(K/64)*8 bytes of mask: 32 MiB an image at K =
//     16384.
//
// What bounds it on the card: it reads K*(16+4+1) bytes and writes K per
// image, and the IoU work is K*K/2 pairs, so neither bytes nor operations
// bound it at K <= 2048. The sweep's serial chain does: K/64 chunks, each 64
// dependent register steps (a bit test into a predicate, a predicated AND),
// one shuffle and a fold of the kept rows; at batch 8 the mask's IoU work
// comes next. Past K = 2048 each chunk of the wide sweep waits on two block
// barriers and an L2 round trip for the kept rows' words.
//
// Changed from the first port of this kernel: that one built both triangles
// in the original index order (half of them never read), and its sweep
// walked the valid boxes one at a time, each step a round trip through
// shared memory by one warp of eight; it took the same time at batch 1 and 8.
//
// IoU uses round-to-nearest intrinsics in the operation order of
// structures/boxes.py::pairwise_iou, so that nvcc cannot contract a*b+c into
// an FMA and flip a borderline iou > thr against the plain version; the
// division is skipped only where its rounding cannot change the answer
// (iou_over).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;       // ranks per chunk = bits per word
constexpr int SWEEP_K = 2048;   // the register sweep's reach: one removed word per lane of a warp
constexpr int SWEEP_WORDS = SWEEP_K / BLOCK;
constexpr int RANK_BOXES = 16;  // boxes per block of the rank kernel,
constexpr int RANK_SPLIT = 16;  // each compared by 16 threads of one warp
constexpr int RANK_TILE = 2048; // keys the rank kernel holds in shared memory at a time
constexpr int MASK_SPLIT = 4;   // threads per row of the mask kernel
constexpr int WIDE_THREADS = 256;  // threads of the wide sweep's block

typedef unsigned long long u64;

size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// u64 words a row of the mask holds: up to SWEEP_K, ceil(K/64) rounded up to
// a power of two >= 2, so that a row is whole 16-byte pieces and WS divides
// the warp; above it, ceil(K/64)
int row_words(int K) {
  if (K > SWEEP_K) return (K + BLOCK - 1) / BLOCK;
  int ws = 2;
  while (ws * BLOCK < K) ws *= 2;
  return ws;
}

// the workspace's parts, each 16-byte aligned: mask [B,K,ws] u64 from 0,
// sorted [B,K,4] f32, rank_of [B,K] i32, n_valid [B] i32
struct Offsets {
  size_t sorted, rank_of, n_valid, bytes;
  Offsets(int B, int K) {
    sorted = align16(sizeof(u64) * B * K * (size_t)row_words(K));
    rank_of = align16(sorted + sizeof(float) * B * K * 4);
    n_valid = align16(rank_of + sizeof(int) * B * K);
    bytes = align16(n_valid + sizeof(int) * B);
  }
};

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ u64 shfl64(u64 v, int src) {
  const unsigned lo = __shfl_sync(0xffffffffu, static_cast<unsigned>(v), src);
  const unsigned hi = __shfl_sync(0xffffffffu, static_cast<unsigned>(v >> 32), src);
  return (static_cast<u64>(hi) << 32) | lo;
}
__device__ __forceinline__ u64 shfl_xor64(u64 v, int mask) {
  const unsigned lo = __shfl_xor_sync(0xffffffffu, static_cast<unsigned>(v), mask);
  const unsigned hi = __shfl_xor_sync(0xffffffffu, static_cast<unsigned>(v >> 32), mask);
  return (static_cast<u64>(hi) << 32) | lo;
}

__global__ void __launch_bounds__(RANK_BOXES * RANK_SPLIT)
nms_rank_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                const uint8_t* __restrict__ valid, int K,
                float4* __restrict__ sorted, int* __restrict__ rank_of,
                int* __restrict__ n_valid) {
  __shared__ float key[RANK_TILE];  // the score of a valid box, NaN for an invalid one
  __shared__ int count;

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * K;
  if (tid == 0) count = 0;

  // a NaN key compares false both ways, so invalid boxes never rank before;
  // the 16 threads of box i take every 16th j of each tile and sum by
  // shuffles
  const int seg = tid % RANK_SPLIT;
  const int i = blockIdx.x * RANK_BOXES + tid / RANK_SPLIT;
  const float si = i < K && valid[base + i] ? scores[base + i] : __int_as_float(0x7fc00000);
  int mine = 0, before = 0;
  for (int t0 = 0; t0 < K; t0 += RANK_TILE) {
    const int tn = min(RANK_TILE, K - t0);
    __syncthreads();  // the last tile's keys are read
    for (int j = tid; j < tn; j += RANK_BOXES * RANK_SPLIT) {
      const bool v = valid[base + t0 + j] != 0;
      key[j] = v ? scores[base + t0 + j] : __int_as_float(0x7fc00000);
      mine += v;
    }
    __syncthreads();
    for (int j = seg; j < tn; j += RANK_SPLIT) {
      const float sj = key[j];
      before += (sj > si) | ((sj == si) & (t0 + j < i));
    }
  }
  atomicAdd(&count, mine);
#pragma unroll
  for (int off = RANK_SPLIT / 2; off > 0; off /= 2) before += __shfl_xor_sync(0xffffffffu, before, off);
  if (seg == 0 && i < K) {
    int r = -1;
    if (valid[base + i]) {
      r = before;  // < count <= K
      const float* bi = boxes + (base + i) * 4;
      sorted[base + r] = make_float4(bi[0], bi[1], bi[2], bi[3]);
    }
    rank_of[base + i] = r;
  }
  __syncthreads();
  if (blockIdx.x == 0 && tid == 0) n_valid[b] = count;
}

// (inter > 0 ? RN(inter / u) : 0) > thr, for u > 0. Where thr > 0 and the
// quotient is more than 2^-21 (relative) away from thr, comparing inter with
// thr * u decides it without the division: thr * u and its scaling by 1 +-
// 2^-20 round by at most 2^-24 each, and a quotient that far from thr rounds
// to the same side of it. The rest divide, rounded to nearest.
__device__ __forceinline__ bool iou_over(float inter, float u, float thr) {
  if (!(inter > 0.f)) return 0.f > thr;
  if (thr > 0.f) {
    const float p = __fmul_rn(thr, u);
    if (inter > __fmul_rn(p, 1.f + 0x1p-20f)) return true;
    if (inter < __fmul_rn(p, 1.f - 0x1p-20f)) return false;
  }
  return __fdiv_rn(inter, u) > thr;
}

__global__ void __launch_bounds__(BLOCK * MASK_SPLIT)
nms_mask_kernel(const float4* __restrict__ sorted, const int* __restrict__ n_valid,
                float thr, int K, int words, int ws, u64* __restrict__ mask) {
  __shared__ float4 cbox[BLOCK];
  __shared__ float carea[BLOCK];

  // blockIdx.x walks the upper triangle row by row: (0,0) .. (0,words-1),
  // (1,1) .. (1,words-1), ..
  const int b = blockIdx.y;
  int rb = 0, cb = blockIdx.x;
  while (cb >= words - rb) cb -= words - rb++;
  cb += rb;
  const int n = n_valid[b];
  if (cb * BLOCK >= n) return;  // no valid column
  const size_t base = (size_t)b * K;
  const int tid = threadIdx.x;
  const int c0 = cb * BLOCK;
  if (tid < BLOCK && c0 + tid < n) {
    const float4 bj = sorted[base + c0 + tid];
    cbox[tid] = bj;
    carea[tid] = area(bj);
  }
  __syncthreads();

  // row r's 64 columns in MASK_SPLIT parts of 16, joined by shuffles
  const int r = rb * BLOCK + tid / MASK_SPLIT;
  const int part = tid % MASK_SPLIT;
  const float4 bi = sorted[base + min(r, n - 1)];
  const float ai = area(bi);
  const int j0 = part * (BLOCK / MASK_SPLIT);
  const int j1 = min(j0 + BLOCK / MASK_SPLIT, n - c0);
  u64 bits = 0ull;
  for (int jj = max(j0, r - c0 + 1); jj < j1; ++jj) {  // ranks after r only
    const float4 bj = cbox[jj];
    const float w = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.f);
    const float h = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.f);
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(ai, carea[jj]), inter);
    if (iou_over(inter, fmaxf(uni, 1e-12f), thr)) bits |= 1ull << jj;
  }
#pragma unroll
  for (int off = MASK_SPLIT / 2; off > 0; off /= 2) bits |= shfl_xor64(bits, off);
  if (part == 0 && r < n) mask[(base + r) * ws + cb] = bits;
}

// if (t & bit) { x &= mx; y &= my; }, written out so that the compiler keeps
// it a test into a predicate and predicated ANDs (two dependent operations)
__device__ __forceinline__ void clear_if(unsigned& x, unsigned& y, unsigned t, unsigned bit,
                                         unsigned mx, unsigned my) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 b;\n\t"
      "and.b32 b, %2, %3;\n\tsetp.ne.b32 p, b, 0;\n\t"
      "@p and.b32 %0, %0, %4;\n\t@p and.b32 %1, %1, %5;\n\t}"
      : "+r"(x), "+r"(y) : "r"(t), "r"(bit), "r"(mx), "r"(my));
}
__device__ __forceinline__ void clear_if(unsigned& x, unsigned t, unsigned bit, unsigned mx) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 b;\n\t"
      "and.b32 b, %1, %2;\n\tsetp.ne.b32 p, b, 0;\n\t@p and.b32 %0, %0, %3;\n\t}"
      : "+r"(x) : "r"(t), "r"(bit), "r"(mx));
}

// the decisions of a chunk of 64 ranks from its diagonal words D: `todo`
// holds its ranks not yet removed; rank j, reached with its bit still set,
// is kept and clears what its diagonal word removes (ranks after j only). A
// step is a bit test into a predicate and a predicated AND.
__device__ __forceinline__ u64 resolve_chunk(u64 todo, const u64* D, int stride) {
  unsigned lo = static_cast<unsigned>(todo);
  unsigned hi = static_cast<unsigned>(todo >> 32);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const u64 d = D[j * stride];
    clear_if(lo, hi, lo, 1u << j, ~static_cast<unsigned>(d), ~static_cast<unsigned>(d >> 32));
  }
#pragma unroll
  for (int j = 32; j < BLOCK; ++j) {
    const unsigned dh = static_cast<unsigned>(D[j * stride] >> 32);
    clear_if(hi, hi, 1u << (j - 32), ~dh);
  }
  return (static_cast<u64>(hi) << 32) | lo;
}

// rows 64c .. 64c+m-1 of the image's mask, words (c & ~1) .. WS-1, into dst
template <int WS>
__device__ __forceinline__ void prefetch_chunk(const u64* __restrict__ mask, u64* dst, int c, int m,
                                               int lane) {
  constexpr int PIECES = WS / 2;  // 16-byte pieces a row
  const int piece = lane % PIECES;
  if (2 * piece >= (c & ~1)) {
    for (int r = lane / PIECES; r < m; r += 32 / PIECES)
      cp_async16(dst + r * WS + 2 * piece, mask + (size_t)(BLOCK * c + r) * WS + 2 * piece);
  }
  cp_async_commit();
}

// WS: the mask's row words (row_words(K)). Lane l keeps removed word l % WS;
// in the fold, the 32 / WS lanes of a word split the chunk's rows between
// them and join their results by shuffles.
template <int WS>
__global__ void __launch_bounds__(32)
nms_sweep_kernel(const u64* __restrict__ mask, const int* __restrict__ n_valid,
                 const int* __restrict__ rank_of, int K, uint8_t* __restrict__ keep) {
  constexpr int GROUPS = 32 / WS;
  __shared__ __align__(16) u64 rows[2][BLOCK * WS];
  __shared__ u64 kept[SWEEP_WORDS];
  __shared__ int rank[SWEEP_K];  // rank_of of this image, copied in while the sweep runs

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int word = lane % WS;
  const int group = lane / WS;
  const size_t base = (size_t)b * K;
  const u64* img = mask + base * WS;
  const int n = n_valid[b];
  const int chunks = (n + BLOCK - 1) / BLOCK;
  u64 removed = 0ull;  // word `word` of the removed bitset

  for (int i = lane; i < K; i += 32) cp_async4(rank + i, rank_of + base + i);
  cp_async_commit();
  if (chunks > 0) prefetch_chunk<WS>(img, rows[0], 0, min(BLOCK, n), lane);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      prefetch_chunk<WS>(img, rows[(c + 1) & 1], c + 1, min(BLOCK, n - BLOCK * (c + 1)), lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const u64* R = rows[c & 1];
    const int m = min(BLOCK, n - BLOCK * c);

    // the chunk's decisions, alike in every lane
    const u64 kc = resolve_chunk(~shfl64(removed, c) & (m == BLOCK ? ~0ull : (1ull << m) - 1), R + c, WS);
    if (lane == 0) kept[c] = kc;

    // the later words: word w of every kept row folds into removed word w
    // (words <= c are decided; their lanes' results are never read); this
    // lane's rows are group, group + GROUPS, ..
    const u64 kg = kc >> group;
    u64 acc[2] = {0ull, 0ull};
#pragma unroll
    for (int t = 0; t < BLOCK / GROUPS; ++t)
      acc[t & 1] |= (kg & (1ull << (GROUPS * t))) != 0ull ? R[(group + GROUPS * t) * WS + word] : 0ull;
    u64 fold = acc[0] | acc[1];
#pragma unroll
    for (int off = WS; off < 32; off *= 2) fold |= shfl_xor64(fold, off);
    if (word > c) removed |= fold;
    __syncwarp();
  }

  cp_async_wait<0>();
  __syncwarp();
  for (int i = lane; i < K; i += 32) {
    const int r = rank[i];
    keep[base + i] = r >= 0 && ((kept[r >> 6] >> (r & 63)) & 1ull);
  }
}

// Above SWEEP_K: one block per image. ws = ceil(K/64) words a row; dynamic
// shared memory holds the removed and kept bitsets, 2 * ws words.
__global__ void __launch_bounds__(WIDE_THREADS)
nms_sweep_wide_kernel(const u64* __restrict__ mask, const int* __restrict__ n_valid,
                      const int* __restrict__ rank_of, int K, int ws, uint8_t* __restrict__ keep) {
  extern __shared__ u64 bitsets[];
  u64* removed = bitsets;
  u64* kept = bitsets + ws;
  __shared__ u64 diag[2][BLOCK];  // the diagonal words of this chunk and the next
  __shared__ int kept_rows[BLOCK];  // the chunk's kept rows, in order

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * K;
  const u64* img = mask + base * ws;
  const int n = n_valid[b];
  const int chunks = (n + BLOCK - 1) / BLOCK;

  for (int w = tid; w < ws; w += WIDE_THREADS) removed[w] = 0ull;
  if (tid < min(BLOCK, n)) diag[0][tid] = img[(size_t)tid * ws];
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int m = min(BLOCK, n - BLOCK * c);
    const int m_next = min(BLOCK, n - BLOCK * (c + 1));
    u64 next = 0ull;
    if (tid < m_next) next = img[(size_t)(BLOCK * (c + 1) + tid) * ws + c + 1];

    // the chunk's decisions, alike in every thread
    const u64 kc = resolve_chunk(~removed[c] & (m == BLOCK ? ~0ull : (1ull << m) - 1), diag[c & 1], 1);
    if (tid < BLOCK && ((kc >> tid) & 1ull)) kept_rows[__popcll(kc & ((1ull << tid) - 1))] = tid;
    if (tid == 0) kept[c] = kc;
    __syncthreads();

    // the later words: word w of every kept row folds into removed word w,
    // one (kept row, word) pair a thread, consecutive threads on consecutive
    // words of a row; words at or past `chunks` hold no valid rank
    const u64* R = img + (size_t)BLOCK * c * ws;
    const int nw = chunks - c - 1;
    const int pairs = __popcll(kc) * nw;
    for (int e = tid; e < pairs; e += WIDE_THREADS) {
      const int w = c + 1 + e % nw;
      const u64 v = R[(size_t)kept_rows[e / nw] * ws + w];
      if (v) atomicOr(removed + w, v);
    }
    if (tid < m_next) diag[(c + 1) & 1][tid] = next;
    __syncthreads();
  }
  for (int i = tid; i < K; i += WIDE_THREADS) {
    const int r = rank_of[base + i];
    keep[base + i] = r >= 0 && ((kept[r >> 6] >> (r & 63)) & 1ull);
  }
}

template <int WS>
cudaError_t sweep(const u64* mask, const int* n_valid, const int* rank_of, int B, int K,
                  uint8_t* keep, cudaStream_t s) {
  nms_sweep_kernel<WS><<<B, 32, 0, s>>>(mask, n_valid, rank_of, K, keep);
  return cudaGetLastError();
}

cudaError_t sweep_wide(const u64* mask, const int* n_valid, const int* rank_of, int B, int K,
                       int ws, uint8_t* keep, cudaStream_t s) {
  const size_t smem = 2 * sizeof(u64) * ws;
  if (smem > 48 * 1024) {  // past the default: opt in (up to 227 KiB, K of about 930000)
    const cudaError_t err = cudaFuncSetAttribute(
        nms_sweep_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nms_sweep_wide_kernel<<<B, WIDE_THREADS, smem, s>>>(mask, n_valid, rank_of, K, ws, keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of the scratch workspace nms_forward needs for B images of K boxes.
extern "C" long long nms_workspace_bytes(int B, int K) {
  return static_cast<long long>(Offsets(B, K).bytes);
}

// boxes [B,K,4] f32, scores [B,K] f32, valid [B,K] uint8, keep [B,K] uint8,
// workspace nms_workspace_bytes(B, K) bytes, 16-byte aligned. All contiguous,
// on the device. Launches the three kernels on `stream` and returns
// cudaGetLastError().
extern "C" int nms_forward(const void* boxes, const void* scores,
                           const void* valid, float thr, int B, int K,
                           void* workspace, void* keep, void* stream) {
  const long long words = (K + (long long)BLOCK - 1) / BLOCK;
  if (B <= 0 || B > 65535 || K <= 0 || words * (words + 1) / 2 > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ws = row_words(K);
  const Offsets off(B, K);
  char* base = static_cast<char*>(workspace);
  u64* mask = reinterpret_cast<u64*>(base);
  float4* sorted = reinterpret_cast<float4*>(base + off.sorted);
  int* rank_of = reinterpret_cast<int*>(base + off.rank_of);
  int* n_valid = reinterpret_cast<int*>(base + off.n_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_rank_kernel<<<dim3((K + RANK_BOXES - 1) / RANK_BOXES, B), RANK_BOXES * RANK_SPLIT, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), K, sorted, rank_of, n_valid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_mask_kernel<<<dim3(static_cast<unsigned>(words * (words + 1) / 2), B), BLOCK * MASK_SPLIT, 0, s>>>(
      sorted, n_valid, thr, K, static_cast<int>(words), ws, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  uint8_t* k8 = static_cast<uint8_t*>(keep);
  switch (ws) {
    case 2: err = sweep<2>(mask, n_valid, rank_of, B, K, k8, s); break;
    case 4: err = sweep<4>(mask, n_valid, rank_of, B, K, k8, s); break;
    case 8: err = sweep<8>(mask, n_valid, rank_of, B, K, k8, s); break;
    case 16: err = sweep<16>(mask, n_valid, rank_of, B, K, k8, s); break;
    case 32: err = sweep<32>(mask, n_valid, rank_of, B, K, k8, s); break;
    default: err = sweep_wide(mask, n_valid, rank_of, B, K, ws, k8, s); break;
  }
  return static_cast<int>(err);
}

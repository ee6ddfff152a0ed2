// Minimum-image pair reduction, batched over frames.
//
// Replaces the Pallas TPU kernel `_pair_tile_kernel`
// (groan_rs_tpu/ops/pallas_kernels.py:27, driven by `_pair_reduce` :71).
// For two atom sets a [N, 3], b [M, 3] of each frame and an orthorhombic
// box L it reduces the minimum-image squared distances
//   d = a - b;  d -= L * floor(d / L + 0.5);  d2 = dx*dx + dy*dy + dz*dz
// to the frame's smallest d2 (the wrapper takes its square root) and to
// the count of pairs with d2 < cutoff^2.  The N x M matrix is never
// stored.  Min and count equal the plain PyTorch twin's bit for bit.
//
// Bound: FP32 instruction issue.  A min-image d2 cannot fuse into FMAs
// (the twin rounds every product and sum on its own; the build uses
// --fmad=false), so the ceiling is 132 SMs x 128 lanes x clock, about
// 3.3e13 instructions/s, and the least exact work is ~25 instructions per
// pair.  The kernel reads ~12 B per atom per frame, so memory is far
// below its bound.  Tensor cores, TMA and wgmma do not apply: the work is
// per-axis min-image arithmetic with exact rounding, not a matrix
// product, and a launch reads tens of MB.
//
// Design:
// * No IEEE division in the hot loop.  q = d * (1/L), with 1/L one true
//   division per frame; k = rint(q) by the 1.5 * 2^23 trick (two adds).
//   Where q lies within the guard of a half-integer, or |q| is too large
//   for the trick, the pairs of that step are recomputed by the reference
//   formula floor(d / L + 0.5) with true division.  Everywhere
//   else k is provably that formula's integer (argument at kTieGuardUlps),
//   and d - L * k, the squares and the sums round as the twin's do.  The
//   guard's width grows with |q|; a bound Q >= |q| for every pair of a
//   work item (from the largest |coordinate| of its two tiles) sets one
//   threshold per item, so the hot loop pays one compare per axis.
// * The smaller set is staged in shared memory as float4 rows (one
//   broadcast LDS.128 per step); each thread keeps kRPerThread atoms of
//   the larger set in registers and walks the whole staged tile.  Lanes
//   past the larger set's ragged end hold NaN coordinates: their d2 is NaN,
//   which neither fminf nor `<` lets through, so nothing is masked.
//   d = a - b keeps its order whichever set is staged: floor(d/L + 0.5) is
//   not odd-symmetric at ties, so a swap would move counts at the cutoff.
// * A grid of about one wave of resident blocks walks the flattened
//   (frame, staged tile, register tile) items in contiguous runs, so a
//   block stages rarely and reduces and makes its two atomics once per
//   frame it touches.  The minimum is an atomicMin on the uint32 bits of
//   d2 (d2 >= 0, where float and bit order agree); the count an atomicAdd
//   on uint64.  Both are order-independent: no float atomics, and every
//   run gives the same bits.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kRPerThread = 4;
constexpr int kRTile = kThreads * kRPerThread;  // register-set atoms per item
constexpr int kSTile = 1024;                    // staged atoms per item (16 KB)
constexpr int kWarps = kThreads / 32;
constexpr float kRound = 12582912.0f;  // 1.5 * 2^23: (q + kRound) - kRound = rint(q), |q| < 2^22

// Tie guard.  With u = 2^-23, x = d / L exactly, q1 = RN(x) (the
// reference's quotient) and q2 = RN(d * RN(1 / L)) (ours):
//   |q1 - x| <= u|x|/2,  |q2 - x| <= u|x| (two roundings of 2^-24 each),
// and RN(q1 + 0.5) moves by at most ulp/2 <= u(|q2| + 1.5)/2.  So
// floor(RN(q1 + 0.5)) = rint(q2) whenever q2 is farther than
//   u * (2|q2| + 1)  <  kTieGuardUlps * u * (Q + 1),   Q >= |q2|,
// from the nearest half-integer: the guard is eight times wider than that
// error bound.  It also sends every pair of an item with Q >= 2^18 - 1
// (where the threshold is negative) to the exact path, well before the
// rint trick fails at 2^22.  NaN and infinite q give NaN d on both paths.
constexpr int kTieGuardUlps = 16;
constexpr float kGuard = kTieGuardUlps * 1.1920928955078125e-07f;  // * 2^-23
constexpr float kHalfMinusGuard = 0.5f - kGuard;

struct Box {
  float len[3], inv[3], inv_max;
};

// Guard threshold for a work item whose quotients satisfy |q| <= qmax.
__device__ __forceinline__ float tie_threshold(float qmax) {
  return __fmaf_rn(qmax, -kGuard, kHalfMinusGuard);
}

// rint(d / L) from the reciprocal; sets `risky` where it may differ from
// floor(d / L + 0.5).
__device__ __forceinline__ float fast_k(float d, float inv, float th,
                                        bool& risky) {
  const float q = __fmul_rn(d, inv);
  const float k = __fsub_rn(__fadd_rn(q, kRound), kRound);
  risky |= fabsf(__fsub_rn(q, k)) > th;
  return k;
}

__device__ __forceinline__ float exact_k(float d, float len) {
  return floorf(__fadd_rn(__fdiv_rn(d, len), 0.5f));
}

__device__ __forceinline__ float wrapped(float d, float len, float k) {
  return __fsub_rn(d, __fmul_rn(len, k));
}

__device__ __forceinline__ float d2_of(float dx, float dy, float dz,
                                      const Box& bx, float kx, float ky,
                                      float kz) {
  const float wx = wrapped(dx, bx.len[0], kx);
  const float wy = wrapped(dy, bx.len[1], ky);
  const float wz = wrapped(dz, bx.len[2], kz);
  float d2 = __fmul_rn(wx, wx);
  d2 = __fadd_rn(d2, __fmul_rn(wy, wy));
  return __fadd_rn(d2, __fmul_rn(wz, wz));
}

// d2 with k from the reciprocal; `risky` is set where that k may differ
// from the reference's on some axis.
__device__ __forceinline__ float fast_d2(float dx, float dy, float dz,
                                         const Box& bx, float th, bool& risky) {
  const float kx = fast_k(dx, bx.inv[0], th, risky);
  const float ky = fast_k(dy, bx.inv[1], th, risky);
  const float kz = fast_k(dz, bx.inv[2], th, risky);
  return d2_of(dx, dy, dz, bx, kx, ky, kz);
}

// d2 by the reference formula, with true division.
__device__ __forceinline__ float exact_d2(float dx, float dy, float dz,
                                          const Box& bx) {
  return d2_of(dx, dy, dz, bx, exact_k(dx, bx.len[0]), exact_k(dy, bx.len[1]),
               exact_k(dz, bx.len[2]));
}

// One axis of d = a - b, whichever set is staged.
template <bool kSIsA>
__device__ __forceinline__ float sub(float s, float r) {
  return kSIsA ? __fsub_rn(s, r) : __fsub_rn(r, s);
}

// Largest value over the block (valid in every thread).
__device__ float block_max(float v) {
  __shared__ float red[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w]);
  __syncthreads();  // red is reused by the next call
  return v;
}

// Block-wide min and count, then one atomic each for frame f.
__device__ void flush(float dmin, unsigned long long cnt, int f,
                      unsigned int* min_bits, unsigned long long* count) {
  __shared__ float red_min[kWarps];
  __shared__ unsigned long long red_cnt[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dmin = fminf(dmin, __shfl_down_sync(0xffffffffu, dmin, off));
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) {
    red_min[warp] = dmin;
    red_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bm = red_min[0];
    unsigned long long bc = red_cnt[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) {
      bm = fminf(bm, red_min[q]);
      bc += red_cnt[q];
    }
    if (bm < INFINITY) atomicMin(min_bits + f, __float_as_uint(bm));
    if (bc) atomicAdd(count + f, bc);
  }
  __syncthreads();  // red_* are reused by the next flush
}

// S: the staged set (n_s atoms), R: the register set (n_r atoms).
// kSIsA: S is a, so d = s - r; else d = r - s.
template <bool kSIsA>
__global__ void __launch_bounds__(kThreads)
pair_reduce_kernel(const float* __restrict__ s, long long s_stride, int n_s,
                   const float* __restrict__ r, long long r_stride, int n_r,
                   const float* __restrict__ boxes, float cut2,
                   long long n_items, long long per_block,
                   unsigned int* __restrict__ min_bits,
                   unsigned long long* __restrict__ count) {
  __shared__ float4 sh[kSTile];
  const int s_tiles = (n_s + kSTile - 1) / kSTile;
  const int r_tiles = (n_r + kRTile - 1) / kRTile;
  const long long per_frame = (long long)s_tiles * r_tiles;
  const long long i0 = (long long)blockIdx.x * per_block;
  const long long i1 = min(i0 + per_block, n_items);

  int cur_f = -1, cur_st = -1, ns = 0;
  float s_max = 0.f;  // largest |coordinate| of the staged tile
  Box bx;
  float dmin = INFINITY;
  unsigned long long cnt = 0;
  for (long long it = i0; it < i1; ++it) {
    const int f = (int)(it / per_frame);
    const long long rem = it - (long long)f * per_frame;
    const int st = (int)(rem / r_tiles);
    const int rt = (int)(rem - (long long)st * r_tiles);
    if (f != cur_f) {
      if (cur_f >= 0) flush(dmin, cnt, cur_f, min_bits, count);
      dmin = INFINITY;
      cnt = 0;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        bx.len[ax] = boxes[f * 3 + ax];
        bx.inv[ax] = __fdiv_rn(1.0f, bx.len[ax]);
      }
      bx.inv_max = fmaxf(bx.inv[0], fmaxf(bx.inv[1], bx.inv[2]));
    }
    if (f != cur_f || st != cur_st) {
      __syncthreads();  // every thread is done with the previous tile
      const float* sf = s + (long long)f * s_stride + (long long)st * kSTile * 3;
      ns = min(kSTile, n_s - st * kSTile);
      float m = 0.f;
      for (int j = threadIdx.x; j < ns; j += kThreads) {
        const float x = sf[j * 3 + 0], y = sf[j * 3 + 1], z = sf[j * 3 + 2];
        sh[j] = make_float4(x, y, z, 0.f);
        m = fmaxf(m, fmaxf(fabsf(x), fmaxf(fabsf(y), fabsf(z))));
      }
      s_max = block_max(m);  // its barriers publish sh[] too
      cur_f = f;
      cur_st = st;
    }

    const float* rf = r + (long long)f * r_stride;
    float rx[kRPerThread], ry[kRPerThread], rz[kRPerThread];
    float r_max = 0.f;
#pragma unroll
    for (int k = 0; k < kRPerThread; ++k) {
      const int i = rt * kRTile + k * kThreads + threadIdx.x;
      const bool ok = i < n_r;
      rx[k] = ok ? rf[(long long)i * 3 + 0] : NAN;
      ry[k] = ok ? rf[(long long)i * 3 + 1] : NAN;
      rz[k] = ok ? rf[(long long)i * 3 + 2] : NAN;
      r_max = fmaxf(r_max, fmaxf(fabsf(rx[k]), fmaxf(fabsf(ry[k]), fabsf(rz[k]))));
    }
    // |q| = |s - r| / L <= (s_max + r_max) * max(1/L) up to a few ulps,
    // which the guard's eightfold margin covers; fmaxf skips NaN lanes.
    const float th = tie_threshold(__fmul_rn(__fadd_rn(s_max, r_max), bx.inv_max));
    unsigned int c = 0;  // <= kRPerThread * kSTile per item
    for (int j = 0; j < ns; ++j) {
      const float4 p = sh[j];
      float d2[kRPerThread];
      bool risky = false;  // one branch for the step's kRPerThread pairs
#pragma unroll
      for (int k = 0; k < kRPerThread; ++k)
        d2[k] = fast_d2(sub<kSIsA>(p.x, rx[k]), sub<kSIsA>(p.y, ry[k]),
                        sub<kSIsA>(p.z, rz[k]), bx, th, risky);
      if (risky) {
#pragma unroll
        for (int k = 0; k < kRPerThread; ++k)
          d2[k] = exact_d2(sub<kSIsA>(p.x, rx[k]), sub<kSIsA>(p.y, ry[k]),
                           sub<kSIsA>(p.z, rz[k]), bx);
      }
#pragma unroll
      for (int k = 0; k < kRPerThread; ++k) {
        dmin = fminf(dmin, d2[k]);
        c += d2[k] < cut2 ? 1u : 0u;
      }
    }
    cnt += c;
  }
  if (cur_f >= 0) flush(dmin, cnt, cur_f, min_bits, count);
}

constexpr int kMaxDevices = 64;

// Blocks of pair_reduce_kernel<kSIsA> that fit on the current device at
// once.  Fixed per device and instance: queried on the first launch there,
// then read from a cache (0 = not yet queried).
template <bool kSIsA>
int resident_blocks() {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached) {
    const int c = cache[dev].load(std::memory_order_relaxed);
    if (c > 0) return c;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pair_reduce_kernel<kSIsA>, kThreads, 0);
  const int blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (cached) cache[dev].store(blocks, std::memory_order_relaxed);
  return blocks;
}

}  // namespace

extern "C" {

// a: [B, N, 3] float32 rows (atom stride 3, frame stride a_stride floats);
// b: [B, M, 3] likewise; boxes: [B, 3]; min_bits: [B] uint32, preset to the
// bits of +inf; count: [B] uint64, preset to 0.  Returns cudaGetLastError().
int gk_pair_reduce(const float* a, long long a_stride, int n, const float* b,
                   long long b_stride, int m, const float* boxes, float cutoff,
                   unsigned int* min_bits, unsigned long long* count,
                   int n_frames, void* stream) {
  if (n <= 0 || m <= 0 || n_frames <= 0) return 0;
  const float cut2 = cutoff * cutoff;
  const bool s_is_a = n <= m;
  const int n_s = s_is_a ? n : m, n_r = s_is_a ? m : n;
  const long long n_items = (long long)n_frames * ((n_s + kSTile - 1) / kSTile) *
                            ((n_r + kRTile - 1) / kRTile);
  const long long resident =
      s_is_a ? resident_blocks<true>() : resident_blocks<false>();
  // Even runs: the fewest items per block that fit one wave of blocks.
  const long long per_block = (n_items + resident - 1) / resident;
  const int grid = (int)((n_items + per_block - 1) / per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_is_a)
    pair_reduce_kernel<true><<<grid, kThreads, 0, st>>>(
        a, a_stride, n, b, b_stride, m, boxes, cut2, n_items, per_block,
        min_bits, count);
  else
    pair_reduce_kernel<false><<<grid, kThreads, 0, st>>>(
        b, b_stride, m, a, a_stride, n, boxes, cut2, n_items, per_block,
        min_bits, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Refined Bai-Breen centre, batched over frames (orthorhombic boxes).
//
// Replaces the two Pallas TPU kernels of groan_rs_tpu/ops/pallas_kernels.py:
//   K1 `_center_tile_kernel` (:159) -> estimate_kernel (one launch)
//   K2 `_refine_tile_kernel` (:250) -> refine_kernel (one launch)
//
// K1, per frame: wrap x into the box, theta = x * (2 pi / L), then
// sum w cos(theta), sum w sin(theta) per axis and sum w; the circular-mean
// estimate is (atan2(-zeta, -xi) + pi) * L / 2 pi (NaN for an empty
// selection).  K2, per frame: unwrap every atom around the estimate
// (`vector_to`) and return sum w x / sum w.
//
// Bound: device-memory bandwidth.  Each pass reads 12 B per atom (plus 4 B
// of weight) and does a few dozen flops per atom, so both passes are bound
// by the copy rate; two passes read the group twice.
//
// Design against the TPU original: the TPU grid walked the atom tiles in
// order and carried the sums in one (8, 128) VMEM block.  Here tiles
// (K1: kAtomsPerBlock atoms, K2: kRefineTile) run in parallel, so each
// tile's sums go to a scratch row [B, tiles, 7|4].  No float atomics: the same input gives the
// same bits on every run, which the resident and streamed passes rely on.
// Positions arrive as [B, N, 3] rows with a free frame stride, so the
// contiguous slice view of a [B, K, 3] batch (the pipeline's `_Idx`
// lowering) is read in place, without a copy.
//
// Both passes are one launch.  A frame's rows are counted in by a ticket
// (atomicAdd on a uint32 per frame) after a fence; the block whose ticket
// completes the frame sums the frame's rows with the whole block in a
// fixed order (thread t takes rows t, t + 256, ...; then a fixed tree),
// writes the frame's result and resets the ticket to 0, so the wrapper's
// cached ticket buffer needs no clearing between calls.  Which block
// finishes does not change the bits.  A thread reads four consecutive
// atoms (48 B) as three float4 when the frame's rows and the weights are
// 16-byte aligned, and as scalars otherwise (a view that starts at an odd
// atom, the ragged tail): the atoms a thread sums and their order do not
// depend on the alignment, so neither do the bits.
//
// K1 runs one block per (tile, frame).  Its angle needs no wrap into the
// box: theta = (pi/2) y with y = x * (4/L), reduced exactly by y - rint(y),
// so a coordinate k boxes away gives the wrapped one's angle up to the
// rounding of y (as large as the twin's own wrap error for coordinates
// within a few boxes).  Sine and cosine come from two short polynomials
// and the quadrant, not from sincosf.
//
// K2 runs at most one wave of resident blocks; block b walks the items
// [b I / G, (b + 1) I / G) of the I = B x tiles (frame, 1024-atom tile)
// items in order, writes one row per item and draws one ticket per frame
// it touches (adding the count of its rows).  A row's atoms and their
// order depend on N alone, not on B, the grid or the alignment, so K2
// calls at different B give the same bits.  The image floor(d / L) of
// the twin costs an IEEE division per coordinate, whose instructions and
// registers (64 a thread: four blocks per SM) held the kernel back; here
// it is floor(d * (1/L)), with 1/L one division per frame, and a thread
// redoes its atoms with the true division wherever d * (1/L) lies within
// kImageGuardUlps of an integer, so every image is the twin's.  A floor
// off by one would move an atom by a box, and a plane of n atoms by
// n L / N, which a sum-order tolerance would not catch.  The exact path
// is not inlined and reloads its atoms: the fast path fits 48 registers,
// five blocks of 256 per SM.
//
// Build with --fmad=false, so that every product and sum rounds as the
// plain PyTorch twin's do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kAtomsPerThread = 8;
constexpr int kAtomsPerBlock = kThreads * kAtomsPerThread;
constexpr int kChunk = 4;  // consecutive atoms a thread reads at once
constexpr int kWarps = kThreads / 32;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;

// K2's tiles: kChunk atoms per thread (1024 atoms).
constexpr int kRefineTile = kThreads * kChunk;
constexpr int kRefineMinBlocks = 5;  // __launch_bounds__: 48 registers a thread

// K2's image guard.  With u = 2^-23, x = d / L exactly, the twin's
// quotient q1 = RN(d / L) and ours q2 = RN(d * RN(1 / L)):
//   |q1 - x| <= u|x|/2,  |q2 - x| <= u|x| (1 + u/2)   (two roundings),
// so |q1 - q2| < 1.6 u |q2| wherever products do not underflow.  floor(q1)
// and floor(q2) differ only if an integer lies between them, so they are
// equal wherever q2 is farther than 1.6 u |q2| from every integer.  The
// fast path takes floor(q2) where q2 is farther than
//   kImageGuardUlps * u * (|q2| + 1)
// from the nearest integer (ten times that bound; the + 1 covers q2 near 0
// and underflow), and the true division elsewhere: within 1.9e-6 (|q2| + 1)
// of an integer (about one coordinate in 10^5 for atoms within a box or
// two), every |q2| >= 2^18 (where the threshold passes 1/2), and NaN or
// infinite q2.  A thread with such a coordinate redoes its atoms of the
// item with the division, so the bits do not depend on the path.
constexpr int kImageGuardUlps = 16;
constexpr float kImageGuard = kImageGuardUlps * 1.1920928955078125e-07f;  // * 2^-23

// CUDA launches made by this file's entry points, one per <<<>>>, so a
// caller can check how many kernels a call runs (one each).
std::atomic<unsigned long long> g_launches{0};

// Sum NV per-thread values over the block in a fixed order; the totals
// are valid in thread 0.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV]) {
  __shared__ float red[NV][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[k][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float x = lane < kWarps ? red[k][lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      v[k] = x;
    }
  }
}

// sin and cos of (pi/2) y: y = n + v with n = rint(y), |v| <= 1/2 exact,
// minimax polynomials for sin(pi v / 2) and cos(pi v / 2) (errors below
// 1e-7, fitted for this file), then the quadrant n mod 4.  Valid for
// |y| < 2^31; y beyond 2^24 is an integer and v = 0.
__device__ __forceinline__ void sincos_halfpi(float y, float& s, float& c) {
  const float n = rintf(y);
  const float v = __fsub_rn(y, n);
  const float u = __fmul_rn(v, v);
  float ps = __fmaf_rn(u, 0.00015819506f, -0.004681261f);
  ps = __fmaf_rn(ps, u, 0.07969258f);
  ps = __fmaf_rn(ps, u, -0.6459641f);
  ps = __fmaf_rn(ps, u, 1.5707964f);
  const float sv = __fmul_rn(ps, v);
  float pc = __fmaf_rn(u, 0.0009036316f, -0.02086007f);
  pc = __fmaf_rn(pc, u, 0.2536692f);
  pc = __fmaf_rn(pc, u, -1.2337005f);
  pc = __fmaf_rn(pc, u, 1.0f);
  const int q = __float2int_rn(n);
  const float a = (q & 1) ? pc : sv;
  const float b = (q & 1) ? sv : pc;
  s = (q & 2) ? -a : a;
  c = ((q + 1) & 2) ? -b : b;
}

// K1: partials[f, blk] = (xi_xyz, zeta_xyz, sum w); the last block of a
// frame reduces the frame's rows into est[f].
__global__ void __launch_bounds__(kThreads)
estimate_kernel(const float* __restrict__ pos, long long frame_stride, int n,
                const float* __restrict__ w, const float* __restrict__ boxes,
                float* __restrict__ partials, unsigned int* __restrict__ tickets,
                float* __restrict__ est) {
  constexpr int kChunks = kAtomsPerThread / kChunk;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int f = blockIdx.y;
  const float* p = pos + (long long)f * frame_stride;
  float len[3], four_over[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    len[ax] = boxes[f * 3 + ax];
    four_over[ax] = __fdiv_rn(4.0f, len[ax]);
  }
  const bool vec = (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
                   (w == nullptr || (reinterpret_cast<uintptr_t>(w) & 15) == 0);
  // every load of the thread first, then the arithmetic
  float x[kChunks][3 * kChunk], wi[kChunks][kChunk];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const long long i0 = (long long)blk * kAtomsPerBlock +
                         ((long long)c * kThreads + threadIdx.x) * kChunk;
    if (vec && i0 + kChunk <= n) {
      const float4* p4 = reinterpret_cast<const float4*>(p + i0 * 3);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 v = __ldg(p4 + q);
        x[c][4 * q + 0] = v.x;
        x[c][4 * q + 1] = v.y;
        x[c][4 * q + 2] = v.z;
        x[c][4 * q + 3] = v.w;
      }
      if (w) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(w + i0));
        wi[c][0] = v.x;
        wi[c][1] = v.y;
        wi[c][2] = v.z;
        wi[c][3] = v.w;
      } else {
#pragma unroll
        for (int a = 0; a < kChunk; ++a) wi[c][a] = 1.0f;
      }
    } else {
#pragma unroll
      for (int a = 0; a < kChunk; ++a) {
        const bool ok = i0 + a < n;
        wi[c][a] = ok ? (w ? w[i0 + a] : 1.0f) : 0.0f;  // 0 adds nothing
#pragma unroll
        for (int ax = 0; ax < 3; ++ax)
          x[c][3 * a + ax] = ok ? p[(i0 + a) * 3 + ax] : 0.0f;
      }
    }
  }
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int a = 0; a < kChunk; ++a) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float sn, cs;
        sincos_halfpi(__fmul_rn(x[c][3 * a + ax], four_over[ax]), sn, cs);
        acc[ax] = __fadd_rn(acc[ax], __fmul_rn(wi[c][a], cs));
        acc[3 + ax] = __fadd_rn(acc[3 + ax], __fmul_rn(wi[c][a], sn));
      }
      acc[6] = __fadd_rn(acc[6], wi[c][a]);
    }
  }
  block_sum<7>(acc);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    float* out = partials + ((long long)f * nblk + blk) * 7;
#pragma unroll
    for (int q = 0; q < 7; ++q) out[q] = acc[q];
    __threadfence();  // the row is visible before the ticket is
    last = atomicAdd(tickets + f, 1u) == (unsigned int)(nblk - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int b = threadIdx.x; b < nblk; b += kThreads) {
    const float* row = partials + ((long long)f * nblk + b) * 7;
#pragma unroll
    for (int q = 0; q < 7; ++q) s[q] += __ldcg(row + q);
  }
  block_sum<7>(s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float theta = atan2f(-s[3 + ax], -s[ax]) + kPi;
      est[f * 3 + ax] = s[6] == 0.0f ? NAN : theta * (len[ax] / kTwoPi);
    }
    tickets[f] = 0;
  }
}

// Count `done` rows of frame f in; the block whose ticket completes the
// frame's `n_tiles` rows sums them in a fixed order into out[f] and resets
// the ticket.  Called by every thread of the block.
__device__ void refine_hand_in(int f, unsigned int done, int n_tiles,
                               const float* __restrict__ partials,
                               unsigned int* __restrict__ tickets,
                               float* __restrict__ out) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();  // this block's rows are visible before its ticket
    last = atomicAdd(tickets + f, done) + done == (unsigned int)n_tiles;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
    const float* row = partials + ((long long)f * n_tiles + t) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] = __fadd_rn(s[q], __ldcg(row + q));
  }
  block_sum<4>(s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) out[f * 3 + ax] = __fdiv_rn(s[ax], s[3]);
    tickets[f] = 0;
  }
  __syncthreads();  // block_sum's scratch and `last` are reused
}

// One axis of one atom: the twin's u = e + ((d - L k) - L/2), added to the
// weighted sum.
__device__ __forceinline__ void refine_add(float& acc, float wi, float d,
                                           float e, float len, float half,
                                           float k) {
  const float u = __fadd_rn(e, __fsub_rn(__fsub_rn(d, __fmul_rn(len, k)), half));
  acc = __fadd_rn(acc, __fmul_rn(wi, u));
}

// One thread's sums over its atoms i0 .. i0 + kChunk - 1, in the fast
// path's order, with the twin's true division: the path of a thread whose
// fast image may be wrong.  Not inlined, and it reloads the atoms, so that
// the fast path holds no registers for it.
__device__ __noinline__ float4 refine_exact(const float* __restrict__ p,
                                            const float* __restrict__ w, int n,
                                            long long i0, float3 e3,
                                            float3 len3, float3 half3) {
  const float e[3] = {e3.x, e3.y, e3.z};
  const float len[3] = {len3.x, len3.y, len3.z};
  const float half[3] = {half3.x, half3.y, half3.z};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int a = 0; a < kChunk; ++a) {
    const bool ok = i0 + a < n;
    const float wa = ok ? (w ? w[i0 + a] : 1.0f) : 0.0f;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float xa = ok ? p[(i0 + a) * 3 + ax] : 0.0f;
      const float d = __fadd_rn(__fsub_rn(xa, e[ax]), half[ax]);
      refine_add(acc[ax], wa, d, e[ax], len[ax], half[ax],
                 floorf(__fdiv_rn(d, len[ax])));
    }
    acc[3] = __fadd_rn(acc[3], wa);
  }
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// K2: partials[f, tile] = (sum w * unwrapped_xyz, sum w) over the tile's
// atoms; out[f] = the frame's sums divided.
__global__ void __launch_bounds__(kThreads, kRefineMinBlocks)
refine_kernel(const float* __restrict__ pos, long long frame_stride, int n,
              const float* __restrict__ w, const float* __restrict__ boxes,
              const float* __restrict__ est, int n_tiles, long long n_items,
              float* __restrict__ partials, unsigned int* __restrict__ tickets,
              float* __restrict__ out) {
  const long long it0 = (long long)blockIdx.x * n_items / gridDim.x;
  const long long it1 = (long long)(blockIdx.x + 1) * n_items / gridDim.x;
  int f = -1;
  unsigned int done = 0;  // rows of frame f this block has written
  const float* p = nullptr;
  bool vec = false;
  float len[3], inv[3], half[3], e[3];
  for (long long it = it0; it < it1; ++it) {
    const int nf = (int)(it / n_tiles);
    const int tile = (int)(it - (long long)nf * n_tiles);
    if (nf != f) {
      if (done) refine_hand_in(f, done, n_tiles, partials, tickets, out);
      f = nf;
      done = 0;
      p = pos + (long long)f * frame_stride;
      vec = (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
            (w == nullptr || (reinterpret_cast<uintptr_t>(w) & 15) == 0);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        len[ax] = boxes[f * 3 + ax];
        inv[ax] = __fdiv_rn(1.0f, len[ax]);
        half[ax] = __fmul_rn(len[ax], 0.5f);
        e[ax] = est[f * 3 + ax];
      }
    }
    const long long i0 = (long long)tile * kRefineTile + threadIdx.x * kChunk;
    // every load of the thread first, then the arithmetic
    float x[3 * kChunk], wi[kChunk];
    if (vec && i0 + kChunk <= n) {
      const float4* p4 = reinterpret_cast<const float4*>(p + i0 * 3);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 v = __ldg(p4 + q);
        x[4 * q + 0] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
      if (w) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(w + i0));
        wi[0] = v.x;
        wi[1] = v.y;
        wi[2] = v.z;
        wi[3] = v.w;
      } else {
#pragma unroll
        for (int a = 0; a < kChunk; ++a) wi[a] = 1.0f;
      }
    } else {
#pragma unroll
      for (int a = 0; a < kChunk; ++a) {
        const bool ok = i0 + a < n;
        wi[a] = ok ? (w ? w[i0 + a] : 1.0f) : 0.0f;  // 0 adds nothing
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) x[3 * a + ax] = ok ? p[(i0 + a) * 3 + ax] : 0.0f;
      }
    }
    // Fast image k = floor(d * (1/L)); `risky` where it may differ from
    // the twin's floor(d / L) (see kImageGuardUlps).
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    bool risky = false;
#pragma unroll
    for (int a = 0; a < kChunk; ++a) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float d = __fadd_rn(__fsub_rn(x[3 * a + ax], e[ax]), half[ax]);
        const float q = __fmul_rn(d, inv[ax]);
        risky |= !(fabsf(__fsub_rn(q, rintf(q))) >
                   __fmaf_rn(fabsf(q), kImageGuard, kImageGuard));
        refine_add(acc[ax], wi[a], d, e[ax], len[ax], half[ax], floorf(q));
      }
      acc[3] = __fadd_rn(acc[3], wi[a]);
    }
    if (risky) {
      const float4 r = refine_exact(p, w, n, i0, make_float3(e[0], e[1], e[2]),
                                    make_float3(len[0], len[1], len[2]),
                                    make_float3(half[0], half[1], half[2]));
      acc[0] = r.x;
      acc[1] = r.y;
      acc[2] = r.z;
      acc[3] = r.w;
    }
    block_sum<4>(acc);
    if (threadIdx.x == 0) {
      float* row = partials + ((long long)f * n_tiles + tile) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) row[q] = acc[q];
    }
    ++done;
    __syncthreads();  // block_sum's scratch is reused by the next item
  }
  if (done) refine_hand_in(f, done, n_tiles, partials, tickets, out);
}

inline int n_blocks(int n, int tile = kAtomsPerBlock) {
  return n > 0 ? (n + tile - 1) / tile : 1;
}

constexpr int kMaxDevices = 64;

// Blocks of refine_kernel that fit on the current device at once.  Fixed
// per device: queried on the first launch there, then read from a cache
// (0 = not yet queried).
int refine_resident_blocks() {
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
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refine_kernel,
                                                kThreads, 0);
  const int blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (cached) cache[dev].store(blocks, std::memory_order_relaxed);
  return blocks;
}

}  // namespace

extern "C" {

// Atoms one tile of K1 and of K2 covers; the wrapper sizes their scratch
// rows [B, ceil(N / this), 7] and [B, ceil(N / this), 4] with them.
int gk_bb_atoms_per_block() { return kAtomsPerBlock; }
int gk_bb_refine_tile() { return kRefineTile; }

// CUDA launches made so far by gk_bb_estimate and gk_bb_refine.
unsigned long long gk_bb_launches() {
  return g_launches.load(std::memory_order_relaxed);
}

// K1.  pos: [B, N, 3] float32 rows (atom stride 3, frame stride
// `frame_stride` floats); w: [N] or NULL (all ones); boxes: [B, 3];
// partials: scratch [B, tiles, 7]; tickets: [>= B] uint32, all 0 on entry
// and on return (the launch leaves them so); est: [B, 3] out.  One launch.
int gk_bb_estimate(const float* pos, long long frame_stride, int n,
                   const float* w, const float* boxes, float* partials,
                   unsigned int* tickets, float* est, int n_frames,
                   void* stream) {
  estimate_kernel<<<dim3(n_blocks(n), n_frames), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      pos, frame_stride, n, w, boxes, partials, tickets, est);
  g_launches.fetch_add(1, std::memory_order_relaxed);
  return static_cast<int>(cudaGetLastError());
}

// K2.  As K1, plus est: [B, 3] (the K1 estimate); partials: scratch
// [B, tiles, 4]; out: [B, 3] refined centre.  One launch.
int gk_bb_refine(const float* pos, long long frame_stride, int n,
                 const float* w, const float* boxes, const float* est,
                 float* partials, unsigned int* tickets, float* out,
                 int n_frames, void* stream) {
  if (n_frames <= 0) return 0;
  const int n_tiles = n_blocks(n, kRefineTile);
  const long long n_items = (long long)n_frames * n_tiles;
  const long long resident = refine_resident_blocks();
  const int grid = (int)(n_items < resident ? n_items : resident);
  refine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, frame_stride, n, w, boxes, est, n_tiles, n_items, partials,
      tickets, out);
  g_launches.fetch_add(1, std::memory_order_relaxed);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Refined Bai-Breen centre, batched over frames (orthorhombic boxes).
//
// Replaces the two Pallas TPU kernels of groan_rs_tpu/ops/pallas_kernels.py:
//   K1 `_center_tile_kernel` (:159) -> estimate_kernel (one launch)
//   K2 `_refine_tile_kernel` (:250) -> refine_partials + refine_finish
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
// order and carried the sums in one (8, 128) VMEM block.  Here the grid is
// (atom blocks x frames) and runs in parallel, so each block writes its
// partial sums to a scratch row [B, nblk, 7|4].  No float atomics: the
// same input gives the same bits on every run, which the resident and
// streamed passes rely on.  Positions arrive as [B, N, 3] rows with a free
// frame stride, so the contiguous slice view of a [B, K, 3] batch (the
// pipeline's `_Idx` lowering) is read in place, without a copy.
//
// K1 is one launch.  Each block writes its row, fences, and takes a
// ticket for its frame (atomicAdd on a uint32 per frame); the block that
// draws the last ticket sums the frame's rows with the whole block in a
// fixed order (thread t takes rows t, t + 256, ...; then a fixed tree),
// writes the estimate and resets the ticket to 0, so the wrapper's cached
// ticket buffer needs no clearing between calls.  Which block finishes
// last does not change the bits.  A thread reads four consecutive atoms
// (48 B) as three float4 when the frame's rows and the weights are
// 16-byte aligned, and as scalars otherwise (a view that starts at an odd
// atom, the ragged tail): the atoms a thread sums and their order do not
// depend on the alignment, so neither do the bits.  The angle needs no
// wrap into the box: theta = (pi/2) y with y = x * (4/L), reduced exactly
// by y - rint(y), so a coordinate k boxes away gives the wrapped one's
// angle up to the rounding of y (as large as the twin's own wrap error
// for coordinates within a few boxes).  Sine and cosine come from two
// short polynomials and the quadrant, not from sincosf.  K2 keeps its
// second launch (`refine_finish`).
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
constexpr int kChunk = 4;  // consecutive atoms a K1 thread reads at once
constexpr int kWarps = kThreads / 32;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;

// CUDA launches made by this file's entry points, one per <<<>>>, so a
// caller can check how many kernels a call runs (K1: one, K2: two).
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

// K2 pass: partials[f, blk] = (sum w * unwrapped_xyz, sum w)
__global__ void __launch_bounds__(kThreads)
refine_partials(const float* __restrict__ pos, long long frame_stride, int n,
                const float* __restrict__ w, const float* __restrict__ boxes,
                const float* __restrict__ est, float* __restrict__ partials) {
  const int blk = blockIdx.x;
  const int f = blockIdx.y;
  const float* p = pos + (long long)f * frame_stride;
  float len[3], half[3], e[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    len[ax] = boxes[f * 3 + ax];
    half[ax] = len[ax] * 0.5f;
    e[ax] = est[f * 3 + ax];
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const long long base = (long long)blk * kAtomsPerBlock;
#pragma unroll 4
  for (int j = 0; j < kAtomsPerThread; ++j) {
    const long long i = base + (long long)j * kThreads + threadIdx.x;
    if (i < n) {
      const float wi = w ? w[i] : 1.0f;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float d = p[i * 3 + ax] - e[ax] + half[ax];
        const float u = e[ax] + (d - len[ax] * floorf(d / len[ax]) - half[ax]);
        acc[ax] += wi * u;
      }
      acc[3] += wi;
    }
  }
  block_sum<4>(acc);
  if (threadIdx.x == 0) {
    float* out = partials + ((long long)f * gridDim.x + blk) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = acc[q];
  }
}

__global__ void refine_finish(const float* __restrict__ partials, int nblk,
                              float* __restrict__ out, int n_frames) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_frames) return;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b = 0; b < nblk; ++b) {
    const float* row = partials + ((long long)f * nblk + b) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += row[q];
  }
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) out[f * 3 + ax] = s[ax] / s[3];
}

inline int n_blocks(int n) {
  return n > 0 ? (n + kAtomsPerBlock - 1) / kAtomsPerBlock : 1;
}

}  // namespace

extern "C" {

// Atoms one block of either pass covers; the wrapper sizes its scratch
// rows [B, ceil(N / this), 7 or 4] with it.
int gk_bb_atoms_per_block() { return kAtomsPerBlock; }

// CUDA launches made so far by gk_bb_estimate and gk_bb_refine.
unsigned long long gk_bb_launches() {
  return g_launches.load(std::memory_order_relaxed);
}

// K1.  pos: [B, N, 3] float32 rows (atom stride 3, frame stride
// `frame_stride` floats); w: [N] or NULL (all ones); boxes: [B, 3];
// partials: scratch [B, nblk, 7]; tickets: [>= B] uint32, all 0 on entry
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
// [B, nblk, 4]; out: [B, 3] refined centre.
int gk_bb_refine(const float* pos, long long frame_stride, int n,
                 const float* w, const float* boxes, const float* est,
                 float* partials, float* out, int n_frames, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = n_blocks(n);
  refine_partials<<<dim3(nblk, n_frames), kThreads, 0, s>>>(
      pos, frame_stride, n, w, boxes, est, partials);
  g_launches.fetch_add(1, std::memory_order_relaxed);
  refine_finish<<<(n_frames + 127) / 128, 128, 0, s>>>(partials, nblk, out,
                                                       n_frames);
  g_launches.fetch_add(1, std::memory_order_relaxed);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Segment max over a constant segment-id array for Hopper (sm_90a), f32.
//
// Replaces sslrec_tpu/ops/pallas_segment.py::_segmax_kernel, the TPU kernel
// behind segment_max_blocked: the softmax shift of every RGAT hop of the KG
// models (attn_aggregate, segment_softmax_blocked).  That kernel padded the
// sorted ids into 256-row x 512-edge chunks and took a one-hot masked max of
// each chunk in VMEM, after XLA gathered data[cols] outside it; the chunk
// tiling exists only because a TPU scatter is serial, so nothing of it is
// carried over.  Here the ids' stable argsort is a CSR layout (indptr over
// segments, perm = slot -> original position), and one launch computes
//
//   out[s] = max_{j in [indptr[s], indptr[s+1])} data[perm[j]]    (-inf if empty)
//
// with the data[perm] gather inside the kernel.
//
// Bound: memory.  It reads data, perm and indptr once and writes out; one
// compare per element is negligible beside that.  Design: one warp per
// segment, 8 segments per 256-thread block.  The lanes stride over the
// segment's slots (coalesced perm reads, gathered data reads), then a
// __shfl_xor_sync butterfly takes the max across the warp.  A max has no
// rounding and the butterfly's order is fixed, so the result is exact and
// deterministic, with no atomics; any n and any segment length are taken.
// The max propagates NaN, as jnp.maximum does (a bare fmaxf would drop it).
//
// Not done here (later work): a segment of ~10 slots leaves most of its
// warp idle; packing several short segments into one warp is the first
// candidate once this kernel shows up in a profile.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  // NaN if either is NaN; else the larger
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_max_kernel(const int* __restrict__ indptr, const int* __restrict__ perm,
                   const float* __restrict__ data, float* __restrict__ out,
                   int n_segments) {
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // seg is the same for all lanes of a warp, so a warp leaves whole and the
  // shuffles below always see all 32 lanes
  if (seg >= n_segments) return;
  const int start = indptr[seg];
  const int end = indptr[seg + 1];
  float m = -CUDART_INF_F;
  for (int j = start + lane; j < end; j += 32) m = nan_max(m, __ldg(data + perm[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(kFullMask, m, off));
  if (lane == 0) out[seg] = m;
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers.  Launches
// on `stream` and returns cudaGetLastError() as an int (0 on success); it
// does not synchronise.
extern "C" int segment_max_f32(const void* indptr, const void* perm, const void* data,
                               void* out, int n_segments, void* stream) {
  if (n_segments <= 0) return 0;
  const int blocks = (n_segments + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_max_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(perm),
      static_cast<const float*>(data), static_cast<float*>(out), n_segments);
  return static_cast<int>(cudaGetLastError());
}

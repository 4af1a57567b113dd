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
// Bound: bytes.  It reads data, perm and indptr once and writes out; one
// compare per element is negligible beside that.  KGCL's segments hold ~10
// slots, so a warp per segment would leave two thirds of its lanes idle and
// take ~3.5 waves of dependent loads.  Design: each segment gets a group of
// W lanes (W a power of two picked on the host from the mean segment length,
// segment_kernel.segmax_group_width), 32/W segments per warp; the group's
// lanes stride over the slots (perm reads coalesced, data reads gathered)
// and a __shfl_xor_sync butterfly of width W takes the max.  A segment of
// more than 4*W slots is skipped there and taken by a whole warp of a second
// bin (warps after the packed ones, one per listed long segment), so a
// segment of thousands of slots runs as fast as before.  A max has no
// rounding and the butterfly's order is fixed, so the result is exact and
// deterministic, with no atomics; any n and any segment length are taken.
// The max propagates NaN, as jnp.maximum does (a bare fmaxf would drop it).
//
// Not done here (later work): segments of 1-2 slots still leave most of a
// group idle; a CUDA graph of the KGCL step would hide the launch, which
// now outlasts the kernel.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  // NaN if either is NaN; else the larger
  return (a != a || a > b) ? a : b;
}

// max over slots [start + lane0, end) in strides of `width`, then a butterfly
// within the `width` lanes of `mask`
__device__ __forceinline__ float group_max(const int* __restrict__ perm,
                                           const float* __restrict__ data, int start, int end,
                                           int sub, int width, unsigned mask) {
  float m = -CUDART_INF_F;
#pragma unroll 4
  for (int j = start + sub; j < end; j += width) m = nan_max(m, __ldg(data + __ldg(perm + j)));
  for (int off = width >> 1; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(mask, m, off, width));
  return m;
}

// Warps [0, n_packed) hold 32/W segments each; warp n_packed + i takes long
// segment long_ids[i] whole.  A group's lanes share their segment, so a
// group leaves whole and its shuffles (masked to the group) see all lanes.
__global__ void __launch_bounds__(kThreads)
segment_max_kernel(const int* __restrict__ indptr, const int* __restrict__ perm,
                   const float* __restrict__ data, float* __restrict__ out, int n_segments,
                   const int* __restrict__ long_ids, int n_long, int log2w, int long_len) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 >> log2w;
  const int n_packed = (n_segments + per_warp - 1) / per_warp;
  if (warp >= n_packed) {
    const int i = warp - n_packed;
    if (i >= n_long) return;
    const int seg = long_ids[i];
    const float m = group_max(perm, data, indptr[seg], indptr[seg + 1], lane, 32, kFullMask);
    if (lane == 0) out[seg] = m;
    return;
  }
  const int w = 1 << log2w;
  const int seg = warp * per_warp + (lane >> log2w);
  if (seg >= n_segments) return;
  const int start = indptr[seg];
  const int end = indptr[seg + 1];
  if (end - start > long_len) return;             // the second bin writes it
  const int sub = lane & (w - 1);
  const unsigned mask = w == 32 ? kFullMask : ((1u << w) - 1u) << (lane & ~(w - 1));
  const float m = group_max(perm, data, start, end, sub, w, mask);
  if (sub == 0) out[seg] = m;
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; long_ids
// lists the segments longer than long_len slots (n_long of them).  Launches
// on `stream` and returns cudaGetLastError() as an int (0 on success); it
// does not synchronise.
extern "C" int segment_max_f32(const void* indptr, const void* perm, const void* data,
                               void* out, int n_segments, const void* long_ids, int n_long,
                               int log2w, int long_len, void* stream) {
  if (n_segments <= 0) return 0;
  if (log2w < 0 || log2w > 5) return static_cast<int>(cudaErrorInvalidValue);
  const int per_warp = 32 >> log2w;
  const long long warps = (n_segments + per_warp - 1) / per_warp + static_cast<long long>(n_long);
  const int blocks = static_cast<int>((warps * 32 + kThreads - 1) / kThreads);
  segment_max_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(perm),
      static_cast<const float*>(data), static_cast<float*>(out), n_segments,
      static_cast<const int*>(long_ids), n_long, log2w, long_len);
  return static_cast<int>(cudaGetLastError());
}

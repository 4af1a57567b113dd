// CSR sparse-matrix x dense-matrix product for Hopper (sm_90a), f32.
//
// Replaces sslrec_tpu/ops/pallas_spmm.py::_spmm_kernel, the TPU kernel that
// runs every graph-propagation hop of LightGCN (forward, and backward on the
// transposed layout).  That kernel reduced padded edge chunks with one-hot
// MXU matmuls because a TPU scatter is serial; on a GPU the same operator is
// a gather plus a per-row reduction, so this kernel computes it directly:
//
//   out[r, :] = sum_{e in [indptr[r], indptr[r+1])} vals[e] * w(e) * x[cols[e], :]
//   w(e) = 1                   when ew == nullptr
//        = ew[edge_ids[e]]     otherwise (a learned edge weight or a constant
//                              dropout mask, both held in the original edge
//                              order; edge_ids maps this layout's slots to it)
//
// Bound: memory.  Each hop reads x, cols, vals, indptr (and edge_ids plus the
// weight when given) and writes out; 2*nnz*d flops are negligible beside that.
// Design: one warp per destination row, 8 rows per 256-thread block.  The
// warp loads up to 32 of the row's edges at once (one per lane), then
// broadcasts each edge with a shuffle while the lanes walk the feature
// dimension in strides of 32, so at d = 32 an edge is one coalesced 128-byte
// read of x[col].  Sums stay in f32 registers and each row's edges are taken
// in order: the result is deterministic and needs no atomics.  An empty row
// writes 0; any d >= 1 is taken.
//
// Not done here (later work): TMA/wgmma staging, and computing the dropout
// mask inside the kernel from the edge id (the PRF now runs as torch ops).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                const float* __restrict__ vals, const int* __restrict__ edge_ids,
                const float* __restrict__ ew, const float* __restrict__ x,
                float* __restrict__ out, int n_rows, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // row is the same for all lanes of a warp, so a warp leaves whole and the
  // shuffles below always see all 32 lanes
  if (row >= n_rows) return;
  const int start = indptr[row];
  const int end = indptr[row + 1];
  for (int f0 = 0; f0 < d; f0 += 32) {
    const int f = f0 + lane;
    float acc = 0.0f;
    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      int c = 0;
      float v = 0.0f;
      if (e < end) {
        c = cols[e];
        v = vals[e];
        if (ew != nullptr) v *= ew[edge_ids[e]];
      }
      const int n = min(32, end - base);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int cj = __shfl_sync(kFullMask, c, j);
        const float vj = __shfl_sync(kFullMask, v, j);
        if (f < d) acc = fmaf(vj, __ldg(x + static_cast<int64_t>(cj) * d + f), acc);
      }
    }
    if (f < d) out[static_cast<int64_t>(row) * d + f] = acc;
  }
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; edge_ids
// and ew are both null or both set.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success); it does not synchronise.
extern "C" int csr_spmm_f32(const void* indptr, const void* cols, const void* vals,
                            const void* edge_ids, const void* ew, const void* x,
                            void* out, int n_rows, int d, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_spmm_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(cols),
      static_cast<const float*>(vals), static_cast<const int*>(edge_ids),
      static_cast<const float*>(ew), static_cast<const float*>(x),
      static_cast<float*>(out), n_rows, d);
  return static_cast<int>(cudaGetLastError());
}

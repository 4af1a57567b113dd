// CSR sparse-matrix x dense-matrix product for Hopper (sm_90a), f32, with a
// bf16 mode.
//
// Replaces sslrec_tpu/ops/pallas_spmm.py::_spmm_kernel, the TPU kernel that
// runs every graph-propagation hop (forward, and backward on the transposed
// layout) and every sorted segment sum of the KG models.  That kernel reduced
// padded edge chunks with one-hot MXU matmuls because a TPU scatter is
// serial; on a GPU the same operator is a gather plus a per-row reduction:
//
//   out[r, :] = sum_{e in [indptr[r], indptr[r+1])} vals[e] * w(e) * x[cols[e], :]
//   vals[e] = 1 where the host marked the layout's values as all ones
//           (vals == nullptr: segment layouts, KGCL's bi-adjacency)
//   w(e) = 1                                   no multiplier
//        = ew[id(e)]                           a learned weight or a materialised mask
//        = floor(U(id(e)) + keep_rate)         edge dropout, evaluated here
//          (/ keep_rate with resize_val)
//   id(e) = edge_ids[e], the original edge index; e itself where the host
//           marked the layout's edge ids as the identity (edge_ids == nullptr)
//   U(i)  = Threefry-2x32 (20 rounds) of (i, salt) under (key0, key1), top 24
//           bits over 2^24: jax.random's bit generator, bit for bit.
//
// Bound: bytes.  A hop reads x, cols, indptr (vals unless they are all ones,
// edge ids on a permuted layout, a mask when one is given) and writes out; 2*nnz*d flops and the
// PRF's ~80 integer operations per edge are far below that.  At LightGCN's
// d = 32, x is 18.5 MB and stays in the 50 MB L2, so the hop is bound by the
// latency of the dependent loads (chunk -> cols -> x) and by how many loads
// are in flight, not by HBM.  The design attacks that:
//
// 1. Work split by edges.  The host (spmm_kernel.split_plan, once per layout
//    and threshold T) cuts every row into chunks of at most T edges.  A row of
//    more than T edges becomes several chunks; each chunk's sum goes to a
//    partials buffer and a second kernel adds a row's partials in chunk order.
//    T follows from nnz and the lane-group width, so a 502-edge row or a
//    41-row relation take with ~7,250 edges per row keeps the card busy.
// 2. Lanes over edges and features together.  A chunk belongs to a group of
//    G lanes, 32/G chunks to a warp; G comes from d (spmm_kernel.lane_group:
//    one lane per two float4s of a row, or per two floats when d % 4, as
//    sweeps on the card chose).  Per batch the group's lanes load G edges'
//    (col, val, w) at once and hand them round with shuffles; the x loads
//    of up to U edges are issued before their FMAs, so several independent
//    16-byte gathers are in flight per lane.
// 3. Any d >= 1 in one pass over the edges: a lane holds NV <= 4 vectors
//    (features (k*G + lane)*VEC), so d = 65 or d = 1 wastes no whole pass;
//    only d > 4*G*VEC takes a second pass.
// 4. The dropout PRF inside the kernel: no mask tensor is built or read, and
//    the forward layout (identity ids) reads no edge ids either, and the
//    Threefry rounds run while the batch's x loads are in flight.  The
//    multiply and the PRF's float steps use __fmul_rn / __fadd_rn /
//    __fdiv_rn, so nvcc contracts nothing and the multiplier equals the
//    materialised mask bit for bit.
//
// Deterministic, no atomics: a chunk's edges are summed in order by one f32
// accumulator per feature, and partials in chunk order, so two calls give
// bit-identical output.  An empty row writes 0.
//
// bf16 mode (the JAX package's SSLREC_PALLAS_PRECISION=default, which halves
// the gathered bytes): x arrives as bf16 rows (the host casts it once a
// call), and each edge's contribution is
//
//   bf16( bf16(x[col]) * bf16(vals[e] * w(e)) )      accumulated in f32,
//
// the product formed in f32 from the two bf16 operands (exact: 8 x 8
// mantissa bits) and rounded once, which is the JAX package's bf16 multiply.
// The f32 mode is untouched by it.
//
// Not done here (later work): TMA / cp.async staging of the edge arrays;
// fusing the split rows' combine into the last-arriving chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNv = 4;
enum Mode { kNone = 0, kTensor = 1, kPrf = 2 };

struct Params {
  const int* chunk_ptr;    // [n_chunks + 1] edge offsets of the chunks
  const int* chunk_dst;    // [n_chunks] out row, or -1 - partial slot
  int n_chunks;
  const int* empty_rows;   // [n_empty] rows with no edge: written 0
  int n_empty;
  const int* cols;
  const float* vals;       // nullptr: all ones
  const int* edge_ids;     // nullptr: the identity
  const float* ew;         // kTensor
  const long long* key;    // kPrf: int64 [2] holding uint32 values
  uint32_t salt;
  float keep_rate;
  int resize_val;
  const void* x;           // float rows, or bf16 rows in bf16 mode
  float* out;
  float* partials;
  int d;
  int log2g;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// floor(U + keep_rate) [/ keep_rate], U the PRF of `count`: the arithmetic of
// spmm_kernel._prf_keep (and of the JAX package's dropout_padded).
__device__ __forceinline__ float dropout_keep(uint32_t k0, uint32_t k1, uint32_t count,
                                              uint32_t salt, float keep_rate, int resize) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = count + ks[0];
  uint32_t x1 = salt + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  const float u = __fmul_rn(static_cast<float>(x0 >> 8), 5.9604644775390625e-8f);  // 2^-24
  const float keep = floorf(__fadd_rn(u, keep_rate));
  return resize ? __fdiv_rn(keep, keep_rate) : keep;
}

template <int VEC>
__device__ __forceinline__ void load_vec(float (&dst)[VEC], const float* src) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
    dst[0] = __ldg(src);
  }
}

// VEC bf16 values (8 bytes for VEC 4) widened to float.
template <int VEC>
__device__ __forceinline__ void load_vec(float (&dst)[VEC], const __nv_bfloat16* src) {
  if constexpr (VEC == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    dst[0] = __low2float(a); dst[1] = __high2float(a);
    dst[2] = __low2float(b); dst[3] = __high2float(b);
  } else {
    dst[0] = __bfloat162float(src[0]);
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float (&src)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else {
    dst[0] = src[0];
  }
}

// One group of G = 2^log2g lanes per item.  Items [0, n_chunks) are chunks,
// the rest empty rows.  A group's lanes share their item, so a group leaves
// whole and its shuffles (masked to the group) always see all its lanes.
template <typename T, int VEC, int NV, int MODE>
__global__ void __launch_bounds__(kThreads) spmm_chunks(const Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  constexpr int U = NV >= 8 ? 1 : 8 / NV;     // edges whose x loads are in flight together
  const int G = 1 << p.log2g;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int item = (blockIdx.x * kThreads + threadIdx.x) >> p.log2g;
  if (item >= p.n_chunks + p.n_empty) return;
  const int d = p.d;
  if (item >= p.n_chunks) {
    float* o = p.out + static_cast<int64_t>(p.empty_rows[item - p.n_chunks]) * d;
    const float zero[VEC] = {};
    for (int f = sub * VEC; f < d; f += G * VEC) store_vec<VEC>(o + f, zero);
    return;
  }
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int start = p.chunk_ptr[item];
  const int end = p.chunk_ptr[item + 1];
  const int dst = p.chunk_dst[item];
  float* o = dst >= 0 ? p.out + static_cast<int64_t>(dst) * d
                      : p.partials + static_cast<int64_t>(-1 - dst) * d;
  uint32_t k0 = 0, k1 = 0;
  if (MODE == kPrf) {
    k0 = static_cast<uint32_t>(p.key[0]);
    k1 = static_cast<uint32_t>(p.key[1]);
  }
  for (int f0 = 0; f0 < d; f0 += G * VEC * NV) {
    float acc[NV][VEC] = {};
    for (int base = start; base < end; base += G) {
      const int e = base + sub;
      const bool live = e < end;
      int c = 0, id = 0;
      float v = 0.0f;
      if (live) {
        c = __ldg(p.cols + e);
        v = p.vals != nullptr ? __ldg(p.vals + e) : 1.0f;
        if (MODE != kNone) id = p.edge_ids != nullptr ? __ldg(p.edge_ids + e) : e;
        if (MODE == kTensor) v = __fmul_rn(v, __ldg(p.ew + id));
      }
      const int n = min(G, end - base);
      for (int j0 = 0; j0 < n; j0 += U) {
        int cj[U];
        float vj[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          cj[u] = __shfl_sync(gmask, c, j0 + u, G);
          if constexpr (MODE != kPrf) vj[u] = __shfl_sync(gmask, v, j0 + u, G);
        }
        float xv[U][NV][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int f = f0 + (k * G + sub) * VEC;
            if (j0 + u < n && f < d)
              load_vec<VEC>(xv[u][k], x + static_cast<int64_t>(cj[u]) * d + f);
          }
        }
        if constexpr (MODE == kPrf) {
          // the PRF runs while the batch's first x loads are in flight
          if (j0 == 0 && live)
            v = __fmul_rn(v, dropout_keep(k0, k1, static_cast<uint32_t>(id), p.salt,
                                          p.keep_rate, p.resize_val));
#pragma unroll
          for (int u = 0; u < U; ++u) vj[u] = __shfl_sync(gmask, v, j0 + u, G);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float vu = kBf16 ? round_bf16(vj[u]) : vj[u];
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int f = f0 + (k * G + sub) * VEC;
            if (j0 + u < n && f < d) {
#pragma unroll
              for (int i = 0; i < VEC; ++i) {
                if constexpr (kBf16)
                  acc[k][i] = __fadd_rn(acc[k][i], round_bf16(__fmul_rn(vu, xv[u][k][i])));
                else
                  acc[k][i] = fmaf(vu, xv[u][k][i], acc[k][i]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int f = f0 + (k * G + sub) * VEC;
      if (f < d) store_vec<VEC>(o + f, acc[k]);
    }
  }
}

// out[split_rows[i], f] = sum of the row's partials, in chunk order; one
// thread per (split row, feature).
__global__ void __launch_bounds__(kThreads)
combine_chunks(const int* __restrict__ split_ptr, const int* __restrict__ split_rows,
               int n_split, const float* __restrict__ partials, float* __restrict__ out,
               int d) {
  constexpr int U = 8;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(n_split) * d) return;
  const int i = static_cast<int>(t / d);
  const int f = static_cast<int>(t % d);
  const int s1 = split_ptr[i + 1];
  float acc = 0.0f;
  for (int s = split_ptr[i]; s < s1; s += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = s + u < s1 ? __ldg(partials + static_cast<int64_t>(s + u) * d + f) : 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (s + u < s1) acc = __fadd_rn(acc, v[u]);
  }
  out[static_cast<int64_t>(split_rows[i]) * d + f] = acc;
}

template <typename T, int VEC, int NV>
void launch_mode(int mode, int blocks, cudaStream_t s, const Params& p) {
  switch (mode) {
    case kNone: spmm_chunks<T, VEC, NV, kNone><<<blocks, kThreads, 0, s>>>(p); break;
    case kTensor: spmm_chunks<T, VEC, NV, kTensor><<<blocks, kThreads, 0, s>>>(p); break;
    default: spmm_chunks<T, VEC, NV, kPrf><<<blocks, kThreads, 0, s>>>(p); break;
  }
}

template <typename T, int VEC>
void launch_nv(int nv, int mode, int blocks, cudaStream_t s, const Params& p) {
  switch (nv) {
    case 1: launch_mode<T, VEC, 1>(mode, blocks, s, p); break;
    case 2: launch_mode<T, VEC, 2>(mode, blocks, s, p); break;
    case 3: launch_mode<T, VEC, 3>(mode, blocks, s, p); break;
    default: launch_mode<T, VEC, kMaxNv>(mode, blocks, s, p); break;
  }
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers.  The plan
// arrays come from spmm_kernel.split_plan; edge_ids is null on a layout whose
// ids are the identity, vals on one whose values are all ones; at most one of
// ew (a [nnz] multiplier in the original edge order) and key (the dropout
// PRF's int64 [2] key) is set; partials holds one d-row per chunk of a split
// row; x holds bf16 rows where x_bf16 is set (the bf16 mode), else float.
// Launches on `stream` and returns the first cudaGetLastError() that is not 0
// (0 on success); it does not synchronise.
extern "C" int csr_spmm_f32(const void* chunk_ptr, const void* chunk_dst, int n_chunks,
                            const void* empty_rows, int n_empty, const void* split_ptr,
                            const void* split_rows, int n_split, const void* cols,
                            const void* vals, const void* edge_ids, const void* ew,
                            const void* key, unsigned salt, float keep_rate, int resize_val,
                            const void* x, void* out, void* partials, int d, int log2g,
                            int x_bf16, void* stream) {
  if (d <= 0 || n_chunks + n_empty <= 0) return 0;
  if (log2g < 0 || log2g > 5) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const int*>(chunk_ptr), static_cast<const int*>(chunk_dst),
                 n_chunks, static_cast<const int*>(empty_rows), n_empty,
                 static_cast<const int*>(cols), static_cast<const float*>(vals),
                 static_cast<const int*>(edge_ids), static_cast<const float*>(ew),
                 static_cast<const long long*>(key), salt, keep_rate, resize_val,
                 x, static_cast<float*>(out),
                 static_cast<float*>(partials), d, log2g};
  const uintptr_t align = x_bf16 ? 7 : 15;     // a 4-vector's bytes, less one
  const bool vec4 = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & align) == 0;
  const int vec = vec4 ? 4 : 1;
  const int nvec = (d + vec - 1) / vec;
  const int g = 1 << log2g;
  const int nv = min(kMaxNv, (nvec + g - 1) / g);
  const int mode = ew != nullptr ? kTensor : key != nullptr ? kPrf : kNone;
  const int64_t threads = static_cast<int64_t>(n_chunks + n_empty) << log2g;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (vec4)
      launch_nv<__nv_bfloat16, 4>(nv, mode, blocks, s, p);
    else
      launch_nv<__nv_bfloat16, 1>(nv, mode, blocks, s, p);
  } else if (vec4) {
    launch_nv<float, 4>(nv, mode, blocks, s, p);
  } else {
    launch_nv<float, 1>(nv, mode, blocks, s, p);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_split <= 0) return err;
  const int64_t cthreads = static_cast<int64_t>(n_split) * d;
  combine_chunks<<<static_cast<int>((cthreads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const int*>(split_ptr), static_cast<const int*>(split_rows), n_split,
      static_cast<const float*>(partials), static_cast<float*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

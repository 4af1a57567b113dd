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
//    more than T edges becomes several chunks, each chunk's sum a partial,
//    added up by the combine tree below.  T follows from nnz and the
//    lane-group width, so a 502-edge row or a 41-row relation take with
//    ~7,250 edges per row keeps the card busy.
// 2. Lanes over edges and features together (d > 4, spmm_chunks).  A chunk
//    belongs to a group of G lanes, 32/G chunks to a warp; G comes from d
//    (spmm_kernel.lane_group: one lane per two 16-byte vectors of a row, or
//    per two values when d % 4, as sweeps on the card chose).  Per batch the
//    group's lanes load G edges' (col, val, w) at once and hand them round with
//    shuffles; the x loads of up to U edges are issued before their FMAs, so
//    several independent 16-byte gathers are in flight per lane.
// 3. Any d > 4 in one pass over the edges: a lane holds NV <= 4 vectors
//    (features (k*G + lane)*VEC), so d = 65 wastes no whole pass; only
//    d > 4*G*VEC takes a second pass.
// 4. Narrow rows, d <= 4 (spmm_narrow).  There a row is one vector or less,
//    so lanes over features would leave all lanes but one of a group without
//    a gather.  Instead each of the group's G lanes takes the chunk's edges
//    e = start + lane + k*G, sums them for all d features in order of k with
//    U independent x loads in flight, and the group adds its lanes' sums by
//    a fixed __shfl_xor_sync butterfly (log2 G steps; a + b is commutative
//    in IEEE arithmetic, so every lane ends with the same bits); lane 0
//    writes.  G and T for this mode come from d (spmm_kernel.lane_group,
//    split_threshold).
// 5. The split rows' combine is a fixed tree.  The plan
//    (spmm_kernel.split_plan) cuts a split row's partials into runs of at
//    most R consecutive ones (R = spmm_kernel.FAN_IN); each run is a tree
//    node whose sum is a partial of the next level, until a row has one
//    node, its root, which writes the row.  A group that has written a
//    partial counts itself in at the partial's node (an integer atomicAdd
//    after a __threadfence); the group that arrives last sums the node's
//    partials in slot order, writes the result and climbs on, so a node is
//    summed by one group, once, in an order fixed by the plan alone.  At
//    d <= 4 the chunks' groups climb inside spmm_narrow (lane-strided over
//    the node's partials with the butterfly), so a call is one launch.  At
//    d > 4 spmm_chunks stays as it was (a climb there cost every chunk of
//    the balanced hops registers and a fence, and slowed LightGCN's hop on
//    an H100), and a second launch, combine_tree, gives each
//    first-level node a group of lanes over features, one 4-vector a lane
//    where 32 lanes allow, which climbs from there.  The serial
//    combine it replaces gave one thread to each (row, feature) and walked
//    all of a row's partials: KMCLR's pad row, 961,308 slots in 30,041 chunks
//    at d 32, took ~1.5 ms in 32 threads; a tree's depth grows with log_R of
//    the partials.  A row of at most R chunks (every row of LightGCN's hop)
//    is one node, summed in the serial combine's order.  The last arriver
//    resets its node's counter to 0, so the counters (the plan's `arrivals`)
//    are zero between calls; two calls on one plan must not run at once.
// 6. The dropout PRF inside the kernel: no mask tensor is built or read, and
//    the forward layout (identity ids) reads no edge ids either, and the
//    Threefry rounds run while the batch's x loads are in flight.  The
//    multiply and the PRF's float steps use __fmul_rn / __fadd_rn /
//    __fdiv_rn, so nvcc contracts nothing and the multiplier equals the
//    materialised mask bit for bit.
//
// Deterministic, no float atomics: every sum is taken in an order fixed by
// the plan (a chunk's edges in order, or lane-strided and the butterfly at
// d <= 4; a node's partials in slot order), so two calls give bit-identical
// output.  An empty row writes 0.  A partial that a group of the same launch
// reads is written and read through L2 (__stcg / __ldcg).
//
// bf16 mode (the JAX package's SSLREC_PALLAS_PRECISION=default): each
// edge's contribution is
//
//   bf16( bf16(x[col]) * bf16(vals[e] * w(e)) )      accumulated in f32,
//
// the JAX package's bf16 multiply, in the same order of sums as the f32 mode.
// The f32 kernel's lanes would give bf16 rows the f32 mode's load count for
// half the bytes, and its arithmetic would make each product an f32
// multiply, a conversion on Hopper's slow F2F pipe and a widening where the
// f32 mode has one FMA (1.8-2.0x the f32 mode's time, PERF.md), so at d > 4
// the mode has its own kernel, spmm_chunks_bf16:
//
// a. Lanes by bytes: over bf16 rows a lane's vector is 16 bytes, 8 values (a
//    4-byte word holds two).  The group is the f32 mode's (one lane per 8
//    values: spmm_kernel.lane_group), so a lane holds one vector where an
//    f32 lane holds two, with 4 edges' loads in flight, and chunks are half
//    as long (spmm_kernel.split_threshold), so a chunk gathers the bytes it
//    would in f32; both were the fastest of a sweep on the card.  Rows are
//    cast only where d % 8 == 0 (else as in c, rounded on load).
// b. Products on the packed pipe: mul.rn.bf16x2 gives the correctly rounded
//    bf16 products of two bf16 pairs in one instruction.  That is the
//    rounding of the exact product, and the f32 product of two bf16 values
//    is exact wherever its bf16 rounding can be non-zero (8 x 8 mantissa
//    bits; one below 2^-134 in magnitude rounds to +-0 both ways), so it
//    equals bf16(f32(a * b)) bit for bit, subnormal products included (PTX's
//    bf16 arithmetic keeps subnormals), and inf, NaN and signed zeros as
//    IEEE gives them.  Each half widens to f32 by a shift or a mask and is
//    added with __fadd_rn, in the edge order the f32 mode has.  The edge's
//    value is rounded to bf16 once, by the lane that loads it.
// c. Which rows: the host casts x to bf16 rows before the call (a torch
//    cast, one pass over x) where d % 8 == 0 and the layout gathers each row
//    of x at least twice on average (spmm_kernel.bf16_rows); else the
//    kernel gathers the f32 rows with the f32 mode's loads and rounds them
//    to bf16 pairs as they arrive (cvt.rn.bf16x2.f32).  A segment sum reads
//    each row once, so there the cast would be a second pass over all of x
//    (0.039 of 0.058 ms at KGCL's d-64 sum; 0.036 ms rounded on load);
//    LightGCN's hop reads a row 3.5 times and is faster cast (PERF.md).
//
// The f32 mode is untouched by it: spmm_chunks is the f32 kernel alone.
// At d <= 4 spmm_narrow serves both modes, the bf16 one on cast rows with an
// f32 multiply and a conversion a product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTreeThreads = 64;  // combine_tree's blocks
constexpr int kMaxNv = 4;
constexpr int kNarrowD = 4;      // widths up to this take spmm_narrow
constexpr int kNarrowU = 4;      // edges (or partials) a lane has in flight there
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

// The split rows' combine tree, apart from Params: spmm_chunks takes Params
// alone, as it was (with the tree's fields in Params, nvcc 12.9 gave its
// LightGCN instance 88 registers instead of 78: two blocks an SM, not three).
struct Tree {
  const int* node_ptr;     // [n_nodes + 1] each tree node's partial slots
  const int* node_dst;     // [n_nodes] out row (a root), or -1 - partial slot
  const int* slot_node;    // [n_partials] the node each partial belongs to
  int* arrivals;           // [n_nodes] arrival counters, 0 between calls
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

// A partial written by another SM: read through L2.
template <int VEC>
__device__ __forceinline__ void load_partial(float (&dst)[VEC], const float* src) {
  if constexpr (VEC == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src));
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
    dst[0] = __ldcg(src);
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The bf16 mode at d > 4 holds bf16 values in pairs, a 4-byte word each,
// the first value in the low half.  The correctly rounded products of two
// pairs (sm_90's packed bf16 multiply).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t prod;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(prod) : "r"(a), "r"(b));
  return prod;
}

// bf16(v) in both halves of a word.
__device__ __forceinline__ uint32_t bf16_pair(float v) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  return h | (h << 16);
}

// Words of a vector of VEC bf16 values.
template <int VEC>
constexpr int kWords = (VEC + 1) / 2;

// Two f32 values rounded to a bf16 pair, a in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A vector of VEC values of a row of x as bf16 words: bf16 rows one 16-byte
// load (VEC 8); f32 rows one 16-byte load (VEC 4) or one value (VEC 1),
// rounded to bf16.
template <typename TX, int VEC>
__device__ __forceinline__ void load_words(uint32_t (&dst)[kWords<VEC>], const TX* src) {
  if constexpr (sizeof(TX) == 2) {
    static_assert(VEC == 8, "bf16 rows load 16-byte vectors");
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = pack_bf16x2(v.x, v.y);
    dst[1] = pack_bf16x2(v.z, v.w);
  } else {
    dst[0] = __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(src)));
  }
}

// acc[i] += bf16(x_i * v), x_i the VEC values in xw and v both halves of vb:
// each packed product's halves widened to f32 (a shift, a mask) and added.
template <int VEC>
__device__ __forceinline__ void add_products(float (&acc)[VEC],
                                             const uint32_t (&xw)[kWords<VEC>], uint32_t vb) {
#pragma unroll
  for (int w = 0; w < kWords<VEC>; ++w) {
    const uint32_t prod = mul_bf16x2(xw[w], vb);
    acc[2 * w] = __fadd_rn(acc[2 * w], __uint_as_float(prod << 16));
    if constexpr (VEC > 1)
      acc[2 * w + 1] = __fadd_rn(acc[2 * w + 1], __uint_as_float(prod & 0xffff0000u));
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float (&src)[VEC]) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(src[4], src[5], src[6], src[7]);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else {
    dst[0] = src[0];
  }
}

// `cg`: a tree node's partial, stored to L2 for the group that sums its
// parent.
template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float (&src)[VEC], bool cg) {
  if (!cg) return store_vec<VEC>(dst, src);
  if constexpr (VEC == 4)
    __stcg(reinterpret_cast<float4*>(dst), make_float4(src[0], src[1], src[2], src[3]));
  else
    __stcg(dst, src[0]);
}

// The group has written partial `slot`; count it in at the slot's node.
// True for the group that arrives last, which then sums the node (`node`).
__device__ __forceinline__ bool arrive(const Tree& tr, int slot, int sub, int G,
                                       unsigned gmask, int& node) {
  __threadfence();
  __syncwarp(gmask);
  node = __ldg(tr.slot_node + slot);
  int last = 0;
  if (sub == 0) {
    const int n = __ldg(tr.node_ptr + node + 1) - __ldg(tr.node_ptr + node);
    last = atomicAdd(tr.arrivals + node, 1) == n - 1;
    if (last) tr.arrivals[node] = 0;           // ready for the next call
  }
  last = __shfl_sync(gmask, last, 0, G);
  if (last) __threadfence();
  return last != 0;
}

// out, or a partial, of a chunk or node whose dst is `dst`.
__device__ __forceinline__ float* dst_row(const Params& p, int dst) {
  return dst >= 0 ? p.out + static_cast<int64_t>(dst) * p.d
                  : p.partials + static_cast<int64_t>(-1 - dst) * p.d;
}

// Lanes over features (d > 4): tree node `node`'s partials summed in slot
// order, U of them in flight, written to the node's dst; returns the dst.
template <int VEC, int NV>
__device__ __forceinline__ int sum_node_wide(const Params& p, const Tree& tr, int node,
                                             int sub, int G) {
  constexpr int U = 16 / NV;
  const int d = p.d;
  const int lo = __ldg(tr.node_ptr + node), hi = __ldg(tr.node_ptr + node + 1);
  const int dst = __ldg(tr.node_dst + node);
  float* o = dst_row(p, dst);
  for (int f0 = 0; f0 < d; f0 += G * VEC * NV) {
    float acc[NV][VEC] = {};
    for (int c0 = lo; c0 < hi; c0 += U) {
      float pv[U][NV][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int f = f0 + (k * G + sub) * VEC;
          if (c0 + u < hi && f < d)
            load_partial<VEC>(pv[u][k], p.partials + static_cast<int64_t>(c0 + u) * d + f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int f = f0 + (k * G + sub) * VEC;
          if (c0 + u < hi && f < d) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[k][i] = __fadd_rn(acc[k][i], pv[u][k][i]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int f = f0 + (k * G + sub) * VEC;
      if (f < d) store_vec<VEC>(o + f, acc[k], dst < 0);
    }
  }
  return dst;
}

// The split rows' combine tree after spmm_chunks (d > 4), in one launch: a
// group of G = 2^log2g lanes per first-level node (the first n_first nodes,
// whose partials spmm_chunks wrote), one vector of a row a lane where G = 32
// allows, then up the tree by arrival.  Small blocks spread the few nodes
// over many SMs.
template <int VEC, int NV>
__global__ void __launch_bounds__(kTreeThreads) combine_tree(const Params p, const Tree tr,
                                                             int n_first, int log2g) {
  const int G = 1 << log2g;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  int node = (blockIdx.x * kTreeThreads + threadIdx.x) >> log2g;
  if (node >= n_first) return;
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  for (int dst = sum_node_wide<VEC, NV>(p, tr, node, sub, G);
       dst < 0 && arrive(tr, -1 - dst, sub, G, gmask, node);
       dst = sum_node_wide<VEC, NV>(p, tr, node, sub, G)) {
  }
}

// One group of G = 2^log2g lanes per item.  Items [0, n_chunks) are chunks,
// the rest empty rows.  A group's lanes share their item, so a group leaves
// whole and its shuffles (masked to the group) always see all its lanes.
template <int VEC, int NV, int MODE>
__global__ void __launch_bounds__(kThreads) spmm_chunks(const Params p) {
  const float* __restrict__ x = static_cast<const float*>(p.x);
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
          const float vu = vj[u];
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int f = f0 + (k * G + sub) * VEC;
            if (j0 + u < n && f < d) {
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[k][i] = fmaf(vu, xv[u][k][i], acc[k][i]);
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

// The bf16 mode at d > 4: spmm_chunks' schedule and order of sums over rows
// of x of type TX (bf16 rows, VEC 8: one 16-byte load; or f32 rows, VEC 4
// or 1 as in spmm_chunks, rounded to bf16 as they load), each product a
// packed bf16 multiply (mul_bf16x2) of the row's pairs and the edge's value,
// rounded to bf16 once by the lane that loads the edge.  A lane of bf16
// rows has at most 4 edges' loads in flight, so a group of 4 lanes shuffles
// no edge it does not hold.
template <typename TX, int VEC, int NV, int MODE>
__global__ void __launch_bounds__(kThreads) spmm_chunks_bf16(const Params p) {
  constexpr int W = kWords<VEC>;
  const TX* __restrict__ x = static_cast<const TX*>(p.x);
  // edges whose x loads are in flight together
  constexpr int U = sizeof(TX) == 4 ? (NV >= 8 ? 1 : 8 / NV) : (NV >= 2 ? 8 / NV : 4);
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
  float* o = dst_row(p, p.chunk_dst[item]);
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
      uint32_t vb = MODE == kPrf ? 0u : bf16_pair(v);
      const int n = min(G, end - base);
      for (int j0 = 0; j0 < n; j0 += U) {
        int cj[U];
        uint32_t vj[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          cj[u] = __shfl_sync(gmask, c, j0 + u, G);
          if constexpr (MODE != kPrf) vj[u] = __shfl_sync(gmask, vb, j0 + u, G);
        }
        uint32_t xw[U][NV][W];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int f = f0 + (k * G + sub) * VEC;
            if (j0 + u < n && f < d)
              load_words<TX, VEC>(xw[u][k], x + static_cast<int64_t>(cj[u]) * d + f);
          }
        }
        if constexpr (MODE == kPrf) {
          // the PRF runs while the batch's first x loads are in flight
          if (j0 == 0 && live)
            vb = bf16_pair(__fmul_rn(v, dropout_keep(k0, k1, static_cast<uint32_t>(id), p.salt,
                                                     p.keep_rate, p.resize_val)));
#pragma unroll
          for (int u = 0; u < U; ++u) vj[u] = __shfl_sync(gmask, vb, j0 + u, G);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int f = f0 + (k * G + sub) * VEC;
            if (j0 + u < n && f < d) add_products<VEC>(acc[k], xw[u][k], vj[u]);
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

// The group's lanes' sums added by a fixed butterfly; every lane ends with
// the same bits.
template <int D>
__device__ __forceinline__ void butterfly(float (&acc)[D], int G, unsigned gmask) {
  for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < D; ++i)
      acc[i] = __fadd_rn(acc[i], __shfl_xor_sync(gmask, acc[i], off, G));
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* o, const float (&acc)[D], bool cg) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (cg) __stcg(o + i, acc[i]);
    else o[i] = acc[i];
  }
}

// One row of x at width D <= 4: one 4-vector where aligned, else D loads.
template <int D>
__device__ __forceinline__ void load_row(float (&dst)[D], const float* src, int vec4) {
  if constexpr (D == 4) {
    if (vec4) {
      load_vec<4>(dst, src);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) dst[i] = __ldg(src + i);
}

template <int D>
__device__ __forceinline__ void load_row(float (&dst)[D], const __nv_bfloat16* src, int vec4) {
  if constexpr (D == 4) {
    if (vec4) {
      load_vec<4>(dst, src);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) dst[i] = __bfloat162float(src[i]);
}

// Lane-strided over a node's partials, then the butterfly: the nodes above
// partial `slot` at width D <= 4.
template <int D>
__device__ void climb_narrow(const Params& p, const Tree& tr, int slot, int sub, int G,
                             unsigned gmask) {
  constexpr int U = kNarrowU;
  int node;
  while (slot >= 0 && arrive(tr, slot, sub, G, gmask, node)) {
    const int lo = __ldg(tr.node_ptr + node), hi = __ldg(tr.node_ptr + node + 1);
    const int dst = __ldg(tr.node_dst + node);
    float acc[D] = {};
    for (int c0 = lo + sub; c0 < hi; c0 += G * U) {
      float pv[U][D];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (c0 + u * G < hi) {
#pragma unroll
          for (int i = 0; i < D; ++i)
            pv[u][i] = __ldcg(p.partials + static_cast<int64_t>(c0 + u * G) * D + i);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (c0 + u * G < hi) {
#pragma unroll
          for (int i = 0; i < D; ++i) acc[i] = __fadd_rn(acc[i], pv[u][i]);
        }
      }
    }
    butterfly<D>(acc, G, gmask);
    if (sub == 0) store_row<D>(dst_row(p, dst), acc, dst < 0);
    slot = dst >= 0 ? -1 : -1 - dst;
  }
}

// d = D <= 4: one group of G lanes per item, each lane over its own edges
// e = start + sub + k*G with U edges' loads in flight, then the butterfly.
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads) spmm_narrow(const Params p, const Tree tr,
                                                        int vec4) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int U = kNarrowU;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int G = 1 << p.log2g;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int item = (blockIdx.x * kThreads + threadIdx.x) >> p.log2g;
  if (item >= p.n_chunks + p.n_empty) return;
  if (item >= p.n_chunks) {
    float* o = p.out + static_cast<int64_t>(p.empty_rows[item - p.n_chunks]) * D;
    for (int f = sub; f < D; f += G) o[f] = 0.0f;
    return;
  }
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int start = p.chunk_ptr[item];
  const int end = p.chunk_ptr[item + 1];
  const int dst = p.chunk_dst[item];
  uint32_t k0 = 0, k1 = 0;
  if (MODE == kPrf) {
    k0 = static_cast<uint32_t>(p.key[0]);
    k1 = static_cast<uint32_t>(p.key[1]);
  }
  float acc[D] = {};
  for (int base = start + sub; base < end; base += G * U) {
    int cj[U], idj[U];
    float vj[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * G;
      cj[u] = idj[u] = 0;
      vj[u] = 0.0f;
      if (e < end) {
        cj[u] = __ldg(p.cols + e);
        vj[u] = p.vals != nullptr ? __ldg(p.vals + e) : 1.0f;
        if (MODE != kNone) idj[u] = p.edge_ids != nullptr ? __ldg(p.edge_ids + e) : e;
      }
    }
    float xv[U][D];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * G < end) load_row<D>(xv[u], x + static_cast<int64_t>(cj[u]) * D, vec4);
    if constexpr (MODE == kTensor) {
      // the weights' loads go out behind the x loads, not before them
      float wj[U];
#pragma unroll
      for (int u = 0; u < U; ++u) wj[u] = base + u * G < end ? __ldg(p.ew + idj[u]) : 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) vj[u] = __fmul_rn(vj[u], wj[u]);
    }
    if constexpr (MODE == kPrf) {
      // the PRF runs while the x loads are in flight
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * G < end)
          vj[u] = __fmul_rn(vj[u], dropout_keep(k0, k1, static_cast<uint32_t>(idj[u]), p.salt,
                                                p.keep_rate, p.resize_val));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * G < end) {
        const float vu = kBf16 ? round_bf16(vj[u]) : vj[u];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          if constexpr (kBf16)
            acc[i] = __fadd_rn(acc[i], round_bf16(__fmul_rn(vu, xv[u][i])));
          else
            acc[i] = fmaf(vu, xv[u][i], acc[i]);
        }
      }
    }
  }
  butterfly<D>(acc, G, gmask);
  if (sub == 0) store_row<D>(dst_row(p, dst), acc, dst < 0);
  if (dst < 0) climb_narrow<D>(p, tr, -1 - dst, sub, G, gmask);
}

// T: x's rows; BF16: the bf16 mode's arithmetic (on bf16 rows always)
template <typename T, int VEC, int NV, bool BF16 = sizeof(T) == 2>
void launch_mode(int mode, int blocks, cudaStream_t s, const Params& p) {
  if constexpr (BF16) {
    switch (mode) {
      case kNone: spmm_chunks_bf16<T, VEC, NV, kNone><<<blocks, kThreads, 0, s>>>(p); break;
      case kTensor: spmm_chunks_bf16<T, VEC, NV, kTensor><<<blocks, kThreads, 0, s>>>(p); break;
      default: spmm_chunks_bf16<T, VEC, NV, kPrf><<<blocks, kThreads, 0, s>>>(p); break;
    }
  } else {
    switch (mode) {
      case kNone: spmm_chunks<VEC, NV, kNone><<<blocks, kThreads, 0, s>>>(p); break;
      case kTensor: spmm_chunks<VEC, NV, kTensor><<<blocks, kThreads, 0, s>>>(p); break;
      default: spmm_chunks<VEC, NV, kPrf><<<blocks, kThreads, 0, s>>>(p); break;
    }
  }
}

template <typename T, int VEC, bool BF16 = sizeof(T) == 2>
void launch_nv(int nv, int mode, int blocks, cudaStream_t s, const Params& p) {
  switch (nv) {
    case 1: launch_mode<T, VEC, 1, BF16>(mode, blocks, s, p); break;
    case 2: launch_mode<T, VEC, 2, BF16>(mode, blocks, s, p); break;
    case 3: launch_mode<T, VEC, 3, BF16>(mode, blocks, s, p); break;
    default: launch_mode<T, VEC, kMaxNv, BF16>(mode, blocks, s, p); break;
  }
}

template <int VEC>
void launch_tree(int nvec, int n_first, cudaStream_t s, const Params& p, const Tree& tr) {
  int log2g = 0;
  while (log2g < 5 && (1 << log2g) < nvec) ++log2g;
  const int nv = min(kMaxNv, (nvec + (1 << log2g) - 1) >> log2g);
  const int blocks = static_cast<int>(
      ((static_cast<int64_t>(n_first) << log2g) + kTreeThreads - 1) / kTreeThreads);
  switch (nv) {
    case 1: combine_tree<VEC, 1><<<blocks, kTreeThreads, 0, s>>>(p, tr, n_first, log2g); break;
    case 2: combine_tree<VEC, 2><<<blocks, kTreeThreads, 0, s>>>(p, tr, n_first, log2g); break;
    case 3: combine_tree<VEC, 3><<<blocks, kTreeThreads, 0, s>>>(p, tr, n_first, log2g); break;
    default:
      combine_tree<VEC, kMaxNv><<<blocks, kTreeThreads, 0, s>>>(p, tr, n_first, log2g);
      break;
  }
}

template <typename T, int D>
void launch_narrow_mode(int mode, int blocks, cudaStream_t s, const Params& p,
                        const Tree& tr, int vec4) {
  switch (mode) {
    case kNone: spmm_narrow<T, D, kNone><<<blocks, kThreads, 0, s>>>(p, tr, vec4); break;
    case kTensor: spmm_narrow<T, D, kTensor><<<blocks, kThreads, 0, s>>>(p, tr, vec4); break;
    default: spmm_narrow<T, D, kPrf><<<blocks, kThreads, 0, s>>>(p, tr, vec4); break;
  }
}

template <typename T>
void launch_narrow(int d, int mode, int blocks, cudaStream_t s, const Params& p,
                   const Tree& tr, int vec4) {
  switch (d) {
    case 1: launch_narrow_mode<T, 1>(mode, blocks, s, p, tr, vec4); break;
    case 2: launch_narrow_mode<T, 2>(mode, blocks, s, p, tr, vec4); break;
    case 3: launch_narrow_mode<T, 3>(mode, blocks, s, p, tr, vec4); break;
    default: launch_narrow_mode<T, kNarrowD>(mode, blocks, s, p, tr, vec4); break;
  }
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers.  The plan
// arrays come from spmm_kernel.split_plan (its combine tree: node_ptr,
// node_dst, slot_node, the zeroed arrivals counters, which a call leaves
// zeroed, and n_first, the first level's nodes); edge_ids is null on a
// layout whose ids are the identity, vals on one whose values are all ones;
// at most one of ew (a [nnz] multiplier in the original edge order) and key
// (the dropout PRF's int64 [2] key) is set; partials holds one d-row per
// partial of the plan; bf16 is 0 for the f32 mode, else the bf16 mode with x
// holding bf16 rows (1; at d > 4 with d % 8 == 0, 16-byte aligned) or f32
// rows rounded as they load (2, d > 4 only).
// d <= 4 takes spmm_narrow, one launch; d > 4
// spmm_chunks (spmm_chunks_bf16 in the bf16 mode), then combine_tree where
// the plan has split rows.  Launches on
// `stream` and returns the first cudaGetLastError() that is not 0 (0 on
// success); it does not synchronise.
extern "C" int csr_spmm_f32(const void* chunk_ptr, const void* chunk_dst, int n_chunks,
                            const void* empty_rows, int n_empty, const void* node_ptr,
                            const void* node_dst, const void* slot_node, void* arrivals,
                            int n_first, const void* cols, const void* vals,
                            const void* edge_ids, const void* ew, const void* key,
                            unsigned salt, float keep_rate, int resize_val, const void* x,
                            void* out, void* partials, int d, int log2g, int bf16,
                            void* stream) {
  if (d <= 0 || n_chunks + n_empty <= 0) return 0;
  const bool x_bf16 = bf16 == 1;
  const bool aligned16 = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (log2g < 0 || log2g > 5 || bf16 < 0 || bf16 > 2 || (bf16 == 2 && d <= kNarrowD) ||
      (x_bf16 && d > kNarrowD && (d % 8 != 0 || !aligned16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = x_bf16 ? 7 : 15;     // a 4-vector's bytes, less one
  const bool vec4 = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & align) == 0;
  const Params p{static_cast<const int*>(chunk_ptr), static_cast<const int*>(chunk_dst),
                 n_chunks, static_cast<const int*>(empty_rows), n_empty,
                 static_cast<const int*>(cols), static_cast<const float*>(vals),
                 static_cast<const int*>(edge_ids), static_cast<const float*>(ew),
                 static_cast<const long long*>(key), salt, keep_rate, resize_val,
                 x, static_cast<float*>(out),
                 static_cast<float*>(partials), d, log2g};
  const Tree tr{static_cast<const int*>(node_ptr), static_cast<const int*>(node_dst),
                static_cast<const int*>(slot_node), static_cast<int*>(arrivals)};
  const int mode = ew != nullptr ? kTensor : key != nullptr ? kPrf : kNone;
  const int64_t threads = static_cast<int64_t>(n_chunks + n_empty) << log2g;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= kNarrowD) {
    if (x_bf16)
      launch_narrow<__nv_bfloat16>(d, mode, blocks, s, p, tr, vec4);
    else
      launch_narrow<float>(d, mode, blocks, s, p, tr, vec4);
    return static_cast<int>(cudaGetLastError());
  }
  const int vec = vec4 ? 4 : 1;              // f32 rows, and the partials
  const int nvec = (d + vec - 1) / vec;
  const int g = 1 << log2g;
  if (x_bf16) {                              // bf16 rows: 16-byte vectors of 8 values
    launch_nv<__nv_bfloat16, 8>(min(kMaxNv, (d / 8 + g - 1) / g), mode, blocks, s, p);
  } else if (bf16 == 2) {                    // f32 rows rounded to bf16 on load
    const int nv = min(kMaxNv, (nvec + g - 1) / g);
    if (vec4)
      launch_nv<float, 4, true>(nv, mode, blocks, s, p);
    else
      launch_nv<float, 1, true>(nv, mode, blocks, s, p);
  } else {
    const int nv = min(kMaxNv, (nvec + g - 1) / g);
    if (vec4)
      launch_nv<float, 4>(nv, mode, blocks, s, p);
    else
      launch_nv<float, 1>(nv, mode, blocks, s, p);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_first <= 0) return err;
  if (vec4)
    launch_tree<4>(nvec, n_first, s, p, tr);
  else
    launch_tree<1>(nvec, n_first, s, p, tr);
  return static_cast<int>(cudaGetLastError());
}

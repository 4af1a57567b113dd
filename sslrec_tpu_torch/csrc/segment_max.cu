// Segment max over a constant segment-id array for Hopper (sm_90a), f32.
//
// Replaces sslrec_tpu/ops/pallas_segment.py::_segmax_kernel, the TPU kernel
// behind segment_max_blocked: the softmax shift of every RGAT hop of the KG
// models (attn_aggregate, segment_softmax_blocked).  That kernel padded the
// sorted ids into 256-row x 512-edge chunks and took a one-hot masked max of
// each chunk in VMEM, after XLA gathered data[cols] outside it; the chunk
// tiling exists only because a TPU scatter is serial, so nothing of it is
// carried over.  Here the ids' stable argsort is a CSR layout (indptr over
// segments, rows = the sorted ids, perm = slot -> original position), and one
// launch computes
//
//   out[s] = max_{j in [indptr[s], indptr[s+1])} data[perm[j] * stride]   (-inf if empty)
//
// with the data[perm] gather inside the kernel, at any element stride (one
// head's column of [n, heads] logits is read where it lies).
//
// Bound: bytes.  It reads data, perm, rows and indptr once and writes out;
// one compare per element is negligible beside that.  At the port's shapes
// (60,000-300,000 slots) the bytes take 0.2-0.8 us, so the time is the
// chain of dependent loads and the launch.
//
// Design: the work is split by slots, not by segments.  Warp w takes the run
// of R = 128 consecutive sorted slots [w R, w R + R), V = 4 slots a lane (one
// 16-byte vector of ids), so the time follows n and the segment count, and
// no segment's length sets it.  A lane reads its V ids and V perm entries as
// 16-byte vectors and has its V data gathers in flight at once; it takes the
// max of each of its segments in order, then a shuffle scan with segment-head
// flags carries each lane's last segment across the warp.  A segment is
// written by its owner, the run of its first slot: where it ends inside that
// run, or inside the next kWindow (32) slots, which every warp gathers beside
// its run (one a lane), so a short segment that straddles two runs needs
// nothing more.  A segment that ends further on is spread, and is combined in
// the same launch, as B1's combine tree combines a split row but without a
// second launch: each run it touches counts its arrival on arrivals[o] with
// an integer atomic as soon as it has read the segment's extent, while its
// data gathers travel, then writes its part (the owner at partials[2 o + 1],
// every later run j at partials[2 j]) tagged with the call's epoch; the run
// that counts last reads the parts with its warp, waiting for any whose store
// has not arrived (a run that has counted is running, so the wait ends,
// however many runs the grid holds), writes the max to out[s] and sets the
// counter back to 0, so the counters are zero between calls (two calls on
// one layout must not run at once: they share the scratch, as calls on one
// stream never do).  The threads past the runs write -inf to the empty
// segments, 4 a thread from indptr.  Blocks hold 128 threads (see below).  A
// max has no rounding and every order here is fixed, so the result is exact
// and the same bits on every call; no float atomic is used.  NaN wins, as in
// jnp.maximum (of several NaNs that differ, the layout fixes which); of -0
// and +0 the max is +0, whatever their order.  Any n below 2^31 - 160 and any
// segment length are taken.
//
// Measured against it (chip_b2_variants.py, four runs on an H100 80GB HBM3
// at 700 W): the simplest exact alternative, out filled with -inf by a
// launch of its own and an integer atomicMax/atomicMin into the segments at
// a run's two ends, is 19-32% faster at DiffKG's denoised heads but 12-22%
// slower at KGCL's, KGRec's and DiffKG's capped heads and the uniform
// layout, and mostly 6-12 us slower a call in event time (two launches); a
// 64-bit arrival count that reads no indptr before it counts is 13-15%
// faster at the denoised heads after an epoch and 5-11% slower at a
// power-law layout.  So neither is taken.  Blocks of 128 threads against 256: 2.6-3.5%
// faster at KGCL's heads, 1.2-2.1% at KGRec's, 0.2-2.1% at the uniform
// layout, 2.6-6.8% at a fresh model's denoised heads; 1.5-2.4% slower at
// DiffKG's capped heads, -3% to +10% at its denoised heads after an epoch
// and -2% to +4% at the power-law layout: 128, faster where the port
// launches B2 most (KGCL).
//
// What is left (chip_compare.py, same card): 0.0029 ms at KGCL's heads
// against a bound of 0.00078, 0.0046 at DiffKG's denoised heads after an
// epoch against 0.00022; the launch and two dependent round trips (ids and
// perm, then data) are most of the time, which a CUDA graph of the step
// would shorten.  A spread segment costs the run that counts last one read
// of the parts after the last part's store: a power-law layout takes 1.34x
// a uniform one of the same n and segment count.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 128;           // threads a block
constexpr int kPerLane = 4;           // slots a lane: one 16-byte vector of ids
constexpr int kRun = 32 * kPerLane;   // slots a warp: segment_kernel.RUN_SLOTS
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWindow = 32;            // segment_kernel.RUN_WINDOW
constexpr int kNoSegment = INT_MAX;    // the id of a slot past n
constexpr int kAhead = 12;             // parts of a spread segment a lane reads at once

struct Args {
  const int* indptr;
  const int* rows;
  const int* perm;
  const float* data;
  int stride;
  float* out;
  int n;
  int n_segments;
  int n_runs;
  unsigned long long* partials;
  int* arrivals;
  unsigned epoch;
};

// A float as an int that orders as the max wants: -0 below +0, a NaN of
// either sign (its sign cleared) above +inf; key_float inverts it.
__device__ __forceinline__ int order_key(float x) {
  int b = __float_as_int(x);
  b = x != x ? b & 0x7fffffff : b;
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void load_slots(const int* __restrict__ p, int s0, int n,
                                           int (&v)[kPerLane], int fill) {
  if (s0 + kPerLane <= n) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p + s0));
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) v[k] = s0 + k < n ? __ldg(p + s0 + k) : fill;
  }
}

__device__ __forceinline__ int part_slot(int owner, int j) {
  return j == 0 ? 2 * owner + 1 : 2 * (owner + j);  // the owner's part, then one a run
}

__device__ __forceinline__ unsigned long long tagged(const Args& a, int key) {
  return static_cast<unsigned long long>(a.epoch) << 32 | static_cast<unsigned>(key);
}

__device__ __forceinline__ int wait_part(const Args& a, int owner, int j) {
  const unsigned long long* slot = a.partials + part_slot(owner, j);
  unsigned long long v = load_relaxed(slot);
  for (int tries = 0; static_cast<unsigned>(v >> 32) != a.epoch; ++tries) {
    if (tries == 1 << 20) __trap();
    v = load_relaxed(slot);
  }
  return static_cast<int>(static_cast<unsigned>(v));
}

// The last part of a spread segment to count its arrival: its warp takes the
// max over the parts j = lane + 32 u, kAhead a lane read at once (its own,
// at own_slot, as it is), writes out[seg] and sets the counter back to 0.
// Every other part has counted, so its warp is running and its store is on
// its way: the parts whose store has not arrived are read again, all at
// once, until they have (after 2^20 rounds the kernel traps rather than
// hang).
__device__ __forceinline__ void combine(const Args& a, int lane, int seg, int owner, int parts,
                                        int own_slot, int own_key) {
  int m = INT_MIN;
  unsigned unseen = 0;
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const int j = lane + 32 * u;
    if (j < parts && part_slot(owner, j) == own_slot) m = own_key;
    if (j < parts && part_slot(owner, j) != own_slot) unseen |= 1u << u;
  }
  for (int round = 0; unseen; ++round) {
    if (round == 1 << 20) __trap();
    unsigned long long v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (unseen >> u & 1u) v[u] = load_relaxed(a.partials + part_slot(owner, lane + 32 * u));
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if ((unseen >> u & 1u) && static_cast<unsigned>(v[u] >> 32) == a.epoch) {
        m = max(m, static_cast<int>(static_cast<unsigned>(v[u])));
        unseen &= ~(1u << u);
      }
  }
  for (int j = lane + 32 * kAhead; j < parts; j += 32) m = max(m, wait_part(a, owner, j));
  m = __reduce_max_sync(kFull, m);
  if (lane == 0) {
    a.out[seg] = key_float(m);
    a.arrivals[owner] = 0;
  }
}

__device__ __forceinline__ void run_max(const Args& a, int run, int lane) {
  constexpr int R = kRun, V = kPerLane;
  const int base = run * R;
  const int s0 = base + V * lane;
  // loads that depend on nothing: the run's ids and perm entries, the
  // window's, and the ids at the slots that place the run's first and last
  // segments (lane 0: base - 1, lane 1: base - R - 1, lane 2: base + 32,
  // lane 31: base + R + 32)
  int id[V], pm[V];
  load_slots(a.rows, s0, a.n, id, kNoSegment);
  load_slots(a.perm, s0, a.n, pm, 0);
  const int ws = base + R + lane;                  // the window: a slot a lane past the run
  const int wid = ws < a.n ? __ldg(a.rows + ws) : kNoSegment;
  const int wpm = ws < a.n ? __ldg(a.perm + ws) : 0;
  const int at = lane == 0 ? base - 1 : lane == 1 ? base - R - 1 : lane == 2 ? base + kWindow
                                                                           : base + R + kWindow;
  const int probe = (lane <= 2 || lane == 31) && at >= 0 && at < a.n ? __ldg(a.rows + at)
                                                                       : kNoSegment;

  const int first = __shfl_sync(kFull, id[0], 0);
  const int last = __shfl_sync(kFull, id[V - 1], 31);
  const int p0 = __shfl_sync(kFull, probe, 0), p1 = __shfl_sync(kFull, probe, 1);
  const int p2 = __shfl_sync(kFull, probe, 2), p31 = __shfl_sync(kFull, probe, 31);
  // first began before the run; it is spread unless its owner, the run
  // before, closed it in its window: unless it began in that run and ends
  // by slot base + 32
  const bool before = p0 == first;
  const bool first_spread = before && (p1 == first || p2 == first);
  // last runs past the run; it is this run's own unless it is first and
  // began before, and then spread if it reaches slot base + R + 32
  const bool runs_on = last != kNoSegment && __shfl_sync(kFull, wid, 0) == last;
  const bool last_own = runs_on && !(last == first && before);
  const bool last_spread = last_own && p31 == last;
  // a spread segment's extent gives its owner and part count: lane 0 holds
  // the first segment's, lane 31 the last one's
  const bool counts = (lane == 0 && first_spread) || (lane == 31 && last_spread);
  int ext0 = 0, ext1 = 0;
  if (counts) {
    const int seg = lane == 0 ? first : last;
    ext0 = __ldg(a.indptr + seg);
    ext1 = __ldg(a.indptr + seg + 1);
  }
  int key[V];
#pragma unroll
  for (int k = 0; k < V; ++k)
    key[k] = id[k] != kNoSegment ? order_key(__ldg(a.data + pm[k] * a.stride)) : INT_MIN;
  // the window's slots of an own last segment that ends in the window
  const int wkey = last_own && !last_spread && wid == last
                       ? order_key(__ldg(a.data + wpm * a.stride)) : INT_MIN;
  // a part of a spread segment counts its arrival while the gathers travel,
  // before its value is known: the last part to count combines the parts,
  // waiting for any whose store has not arrived
  const int owner = ext0 / R;
  const int parts = (ext1 - 1) / R - owner + 1;
  const bool last_to_count = counts && atomicAdd(a.arrivals + owner, 1) == parts - 1;

  const int fid = id[0], lid = id[V - 1];
  const int prev_lid = __shfl_up_sync(kFull, lid, 1);

  // the lane's segments in order: the first one's max (head), every one
  // between written whole (it lies in the lane), the last one's max (m)
  int head = INT_MIN, m = key[0], cur = fid;
#pragma unroll
  for (int k = 1; k < V; ++k) {
    if (id[k] != cur) {
      if (cur == fid)
        head = m;
      else
        a.out[cur] = key_float(m);
      cur = id[k];
      m = key[k];
    } else {
      m = max(m, key[k]);
    }
  }

  // inclusive max-scan over the lanes of (lid, key) packed in 64 bits: the
  // ids rise along the warp, so each lane gets the max of its lid over
  // lid's slots in this run up to its end (lanes of a lower id lose)
  const int next_fid = __shfl_down_sync(kFull, fid, 1);
  unsigned long long scan = (static_cast<unsigned long long>(static_cast<unsigned>(lid)) << 32) |
                            (static_cast<unsigned>(m) ^ 0x80000000u);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long up = __shfl_up_sync(kFull, scan, off);
    if (lane >= off) scan = max(scan, up);
  }
  const int g_max = static_cast<int>(static_cast<unsigned>(scan) ^ 0x80000000u);
  const int prev_max = __shfl_up_sync(kFull, g_max, 1);
  const int end_max = __shfl_sync(kFull, g_max, 31);   // last's slots in this run

  // segments that end in this lane: written, skipped (the run before closed
  // it), or, the run's first segment if spread, kept as its part
  bool has_part = false;
  int part = 0;
  auto finish = [&](int seg, int k) {
    if (seg == kNoSegment) return;
    if (seg == first && before) {
      has_part = first_spread;
      part = k;
    } else {
      a.out[seg] = key_float(k);
    }
  };
  if (fid != lid) finish(fid, lane > 0 && prev_lid == fid ? max(prev_max, head) : head);
  if (lane < 31 ? next_fid != lid : !runs_on) finish(lid, g_max);

  if (runs_on && last_own && !last_spread) {       // it ends in the window
    const int w = __reduce_max_sync(kFull, wkey);
    if (lane == 0) a.out[last] = key_float(max(end_max, w));
  }
  // a spread first segment's part goes to lane 0, a spread last one's to 31
  if (!first_spread && !last_spread) return;
  const unsigned with_part = __ballot_sync(kFull, has_part);
  const int in_part = with_part ? __shfl_sync(kFull, part, __ffs(with_part) - 1) : end_max;
  if (lane == 0 && first_spread) store_relaxed(a.partials + 2 * run, tagged(a, in_part));
  if (lane == 31 && last_spread) store_relaxed(a.partials + 2 * run + 1, tagged(a, end_max));
  const unsigned last_in = __ballot_sync(kFull, last_to_count);
  if (last_in & 1u)
    combine(a, lane, first, __shfl_sync(kFull, owner, 0), __shfl_sync(kFull, parts, 0), 2 * run,
            in_part);
  if (last_in >> 31)
    combine(a, lane, last, run, __shfl_sync(kFull, parts, 31), 2 * run + 1, end_max);
}

// Warp w < n_runs takes run w; each thread past the runs checks 4 segments
// (indptr read as a 16-byte vector) and writes -inf to the empty ones; with
// no slots, thread t writes -inf to segment t.
__global__ void __launch_bounds__(kBlock, 4) segment_max_runs(Args a) {
  const long long thread = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (a.n == 0) {
    if (thread < a.n_segments) a.out[thread] = -CUDART_INF_F;
    return;
  }
  const int warp = static_cast<int>(thread >> 5), lane = threadIdx.x & 31;
  if (warp < a.n_runs) {
    run_max(a, warp, lane);
    return;
  }
  const int s0 = 4 * ((warp - a.n_runs) * 32 + lane);
  if (s0 >= a.n_segments) return;
  int e[5];
  if (s0 + 4 <= a.n_segments) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(a.indptr + s0));
    e[0] = w.x; e[1] = w.y; e[2] = w.z; e[3] = w.w;
    e[4] = __ldg(a.indptr + s0 + 4);
  } else {
#pragma unroll
    for (int k = 0; k < 5; ++k) e[k] = s0 + k <= a.n_segments ? __ldg(a.indptr + s0 + k) : 0;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (s0 + k < a.n_segments && e[k] == e[k + 1]) a.out[s0 + k] = -CUDART_INF_F;
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers: indptr,
// rows and perm 16-byte aligned; partials uint64 [2 n_runs] (zero before the
// first call) and arrivals int32 [n_runs] (zero) for n_runs = ceil(n / 128);
// epoch differs from every earlier call's on these and is not 0.  data is
// read at element stride `stride`.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success); it does not synchronise.
extern "C" int segment_max_f32(const void* indptr, const void* rows, const void* perm,
                               const void* data, int stride, void* out, int n,
                               int n_segments, void* partials, void* arrivals, unsigned epoch,
                               void* stream) {
  if (n_segments <= 0) return 0;
  if (n < 0 || n > INT_MAX - kRun - kWindow || n_segments > INT_MAX - 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_runs = static_cast<int>((static_cast<long long>(n) + kRun - 1) / kRun);
  const long long threads = n == 0 ? n_segments : 32LL * (n_runs + (n_segments + 127LL) / 128);
  const int blocks = static_cast<int>((threads + kBlock - 1) / kBlock);
  const Args a{static_cast<const int*>(indptr), static_cast<const int*>(rows),
               static_cast<const int*>(perm),   static_cast<const float*>(data),
               stride,                          static_cast<float*>(out),
               n,                               n_segments,
               n_runs,                          static_cast<unsigned long long*>(partials),
               static_cast<int*>(arrivals),     epoch};
  segment_max_runs<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

"""B2 (``csrc/segment_max.cu``) against variants of its design, on one card.

    python3 chip_b2_variants.py

Times, at each shape of ``chip_compare.B2_SHAPES`` (its ids built by
``chip_compare.build_b2_operands`` when ``build/chip_compare_b2.pt`` is
missing), these builds of B2, each held bit for bit against
``segment_max_plain`` and against its own second call:

- ``kernel``: ``csrc/segment_max.cu`` as it is (blocks of 128 threads);
- ``block256``: the same in blocks of 256 threads;
- ``count64``: a spread segment's arrivals counted on a 64-bit word keyed
  by segment, so that no run reads ``indptr`` before it counts (the owner
  adds 2^30 − its run and the run where the segment ends its run + 1 to the
  high word, every part 1 to the low word; the count is whole when the high
  word less 2^30 equals the low one); a run in the middle of the segment
  that counts last reads ``indptr`` for the owner after its count;
- ``count64e``: ``count64`` with that read made early, beside the data
  gathers, by every middle run;
- ``atomic``: the simplest exact design without the in-launch combine:
  ``out`` filled with −inf by ``torch.full``, then one launch in which each
  warp writes the segments that lie in its run of 128 slots and takes an
  integer ``atomicMax`` / ``atomicMin`` on the float's bits into the two
  that cross its ends (exact, and the same bits on every call: a max has no
  rounding).

Each variant is built by nvcc from the text of ``csrc/segment_max.cu``
(the others but ``atomic`` replace a few lines of it) or from
:data:`ATOMIC_SOURCE`, into ``build/b2_variants/``.  Device times come from
``chip_smoke.device_ms`` (the kernels of a call summed, the fill included),
taken in two passes over the variants, the second in reverse order, with
CUDA-event times (``chip_smoke.time_ms``) beside them.  Prints one JSON
object a shape, then the card's name and power limit; writes the whole to
``chiprun_out/b2_variants.json``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(HERE, "build", "b2_variants")
SOURCE = os.path.join(HERE, "sslrec_tpu_torch", "csrc", "segment_max.cu")

# (old, new) replacements of segment_max.cu's text; each old occurs once
BLOCK256 = (("constexpr int kBlock = 128;", "constexpr int kBlock = 256;"),)
EXTENT = """  const bool counts = (lane == 0 && first_spread) || (lane == 31 && last_spread);
  int ext0 = 0, ext1 = 0;
  if (counts) {
    const int seg = lane == 0 ? first : last;
    ext0 = __ldg(a.indptr + seg);
    ext1 = __ldg(a.indptr + seg + 1);
  }
"""
COUNT = """  const int owner = ext0 / R;
  const int parts = (ext1 - 1) / R - owner + 1;
  const bool last_to_count = counts && atomicAdd(a.arrivals + owner, 1) == parts - 1;
"""
COMBINE = """  if (last_in & 1u)
    combine(a, lane, first, __shfl_sync(kFull, owner, 0), __shfl_sync(kFull, parts, 0), 2 * run,
            in_part);"""
COUNT64_ADD = """  const unsigned long long add =
      1ull | static_cast<unsigned long long>(lane == 31 ? kBase - run : ends_here ? run + 1 : 0)
                 << 32;
  int parts = 0;
  if (counts) {
    const unsigned long long now =
        atomicAdd(a.arrivals + (lane == 0 ? first : last), add) + add;
    const long long c = static_cast<long long>(now & 0xffffffffull);
    if (static_cast<long long>(now >> 32) - kBase == c) parts = static_cast<int>(c);
  }
  const bool last_to_count = parts > 0;
"""
COUNT64_SCRATCH = (
    ("constexpr int kAhead = 12;", "constexpr int kAhead = 12;\nconstexpr int kBase = 1 << 30;"),
    ("  int* arrivals;\n", "  unsigned long long* arrivals;\n"),
    ("    a.arrivals[owner] = 0;", "    a.arrivals[seg] = 0;"),
    ("static_cast<int*>(arrivals),     epoch};",
     "static_cast<unsigned long long*>(arrivals), epoch};"))
COUNT64 = COUNT64_SCRATCH + (
    (EXTENT, ""),
    (COUNT, """  const bool counts = (lane == 0 && first_spread) || (lane == 31 && last_spread);
  const bool ends_here = !(runs_on && last == first);
""" + COUNT64_ADD),
    (COMBINE, """  if (last_in & 1u) {
    const int in_parts = __shfl_sync(kFull, parts, 0);
    const int owner = ends_here ? run - in_parts + 1 : __ldg(a.indptr + first) / R;
    combine(a, lane, first, owner, in_parts, 2 * run, in_part);
  }"""))
COUNT64E = COUNT64_SCRATCH + (
    (EXTENT, """  const bool counts = (lane == 0 && first_spread) || (lane == 31 && last_spread);
  const bool ends_here = !(runs_on && last == first);
  const int start = lane == 0 && first_spread && !ends_here ? __ldg(a.indptr + first) : 0;
"""),
    (COUNT, COUNT64_ADD),
    (COMBINE, """  if (last_in & 1u) {
    const int in_parts = __shfl_sync(kFull, parts, 0);
    const int owner = ends_here ? run - in_parts + 1 : __shfl_sync(kFull, start, 0) / R;
    combine(a, lane, first, owner, in_parts, 2 * run, in_part);
  }"""))

ATOMIC_SOURCE = r"""
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoSegment = INT_MAX;

__device__ __forceinline__ int order_key(float x) {
  int b = __float_as_int(x);
  b = x != x ? b & 0x7fffffff : b;
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// out[seg] = max(out[seg], the float of key): an int max on the bits of a
// float of sign 0, an unsigned min on those of sign 1 (-0 below +0, a NaN
// of sign 0 above +inf, as the order key)
__device__ __forceinline__ void max_into(float* p, int key) {
  const int b = __float_as_int(key_float(key));
  if (b >= 0)
    atomicMax(reinterpret_cast<int*>(p), b);
  else
    atomicMin(reinterpret_cast<unsigned*>(p), static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(256) segmax_atomic(const int* __restrict__ rows,
                                                     const int* __restrict__ perm,
                                                     const float* __restrict__ data, int stride,
                                                     float* out, int n) {
  const long long thread = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const int base = static_cast<int>(thread >> 5) * 128, lane = threadIdx.x & 31;
  if (base >= n) return;
  const int s0 = base + 4 * lane;
  int id[4], pm[4];
  if (s0 + 4 <= n) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(rows + s0));
    const int4 q = __ldg(reinterpret_cast<const int4*>(perm + s0));
    id[0] = r.x; id[1] = r.y; id[2] = r.z; id[3] = r.w;
    pm[0] = q.x; pm[1] = q.y; pm[2] = q.z; pm[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      id[k] = s0 + k < n ? __ldg(rows + s0 + k) : kNoSegment;
      pm[k] = s0 + k < n ? __ldg(perm + s0 + k) : 0;
    }
  }
  const int at = lane == 0 ? base - 1 : base + 128;
  const int probe = (lane == 0 || lane == 31) && at >= 0 && at < n ? __ldg(rows + at) : kNoSegment;
  const int first = __shfl_sync(kFull, id[0], 0), last = __shfl_sync(kFull, id[3], 31);
  const bool before = __shfl_sync(kFull, probe, 0) == first;
  const bool after = last != kNoSegment && __shfl_sync(kFull, probe, 31) == last;
  int key[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    key[k] = id[k] != kNoSegment ? order_key(__ldg(data + pm[k] * stride)) : INT_MIN;
  const int fid = id[0], lid = id[3];
  const int prev_lid = __shfl_up_sync(kFull, lid, 1);
  int head = INT_MIN, m = key[0], cur = fid;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (id[k] != cur) {
      if (cur == fid)
        head = m;
      else
        out[cur] = key_float(m);
      cur = id[k];
      m = key[k];
    } else {
      m = max(m, key[k]);
    }
  }
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
  auto finish = [&](int seg, int k) {
    if (seg == kNoSegment) return;
    if ((seg == first && before) || (seg == last && after))
      max_into(out + seg, k);
    else
      out[seg] = key_float(k);
  };
  if (fid != lid) finish(fid, lane > 0 && prev_lid == fid ? max(prev_max, head) : head);
  if (lane == 31 || next_fid != lid) finish(lid, g_max);
}

}  // namespace

// out float [n_segments] holds -inf before the call
extern "C" int segment_max_atomic_f32(const void* rows, const void* perm, const void* data,
                                      int stride, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const long long threads = 32LL * ((n + 127LL) / 128);
  segmax_atomic<<<static_cast<int>((threads + 255) / 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(perm),
      static_cast<const float*>(data), stride, static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
"""

VARIANTS = ("kernel", "block256", "count64", "count64e", "atomic")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sources() -> dict[str, str]:
    """Each variant's CUDA source."""
    text = open(SOURCE).read()

    def patched(pairs):
        out = text
        for old, new in pairs:
            if out.count(old) != 1:
                raise AssertionError(f"segment_max.cu: {old[:60]!r} occurs {out.count(old)} times")
            out = out.replace(old, new)
        return out

    return {"kernel": text, "block256": patched(BLOCK256), "count64": patched(COUNT64),
            "count64e": patched(COUNT64E), "atomic": ATOMIC_SOURCE}


def build() -> dict[str, ctypes.CDLL]:
    """Every variant compiled at once, one nvcc each; raises on a failure."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, text in sources().items():
        src, so = os.path.join(BUILD, f"{name}.cu"), os.path.join(BUILD, f"lib{name}.so")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, failed = {}, []
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        regs = [line.strip() for line in out.splitlines() if "registers" in line]
        print(f"{name}: {regs}", file=sys.stderr)
        libs[name] = ctypes.CDLL(so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def calls(libs, lay, data):
    """{variant: a function that runs it once on ``data`` and returns out}."""
    import torch

    p, i = ctypes.c_void_p, ctypes.c_int
    dev = data.device
    csr = lay.csr
    n_runs = -(-lay.n // 128)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = {}
    for name in ("kernel", "block256", "count64", "count64e"):
        fn = libs[name].segment_max_f32
        fn.argtypes = [p, p, p, p, i, p, i, i, p, p, ctypes.c_uint, p]
        fn.restype = ctypes.c_int
        partials = torch.zeros(2 * n_runs + 1, dtype=torch.int64, device=dev)
        arrivals = torch.zeros(max(n_runs, lay.num_segments) + 1, dtype=torch.int64, device=dev)
        epoch = [0]

        def run(fn=fn, partials=partials, arrivals=arrivals, epoch=epoch):
            out = torch.empty(lay.num_segments, dtype=torch.float32, device=dev)
            epoch[0] += 1
            err = fn(csr.indptr.data_ptr(), csr.rows.data_ptr(), csr.cols.data_ptr(),
                     data.data_ptr(), data.stride(0), out.data_ptr(), lay.n, lay.num_segments,
                     partials.data_ptr(), arrivals.data_ptr(), epoch[0], stream)
            if err:
                raise RuntimeError(f"cudaError {err}")
            return out

        fns[name] = run
    atomic = libs["atomic"].segment_max_atomic_f32
    atomic.argtypes = [p, p, p, i, p, i, p]
    atomic.restype = ctypes.c_int

    def run_atomic():
        out = torch.full((lay.num_segments,), float("-inf"), device=dev)
        err = atomic(csr.rows.data_ptr(), csr.cols.data_ptr(), data.data_ptr(), data.stride(0),
                     out.data_ptr(), lay.n, stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
        return out

    fns["atomic"] = run_atomic
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_b2_variants: torch.cuda.is_available() is False; needs a CUDA card")
    compare = _load("chip_compare", os.path.join(HERE, "chip_compare.py"))
    if not os.path.exists(compare.B2_OPERANDS):
        compare.build_b2_operands()
    cs = compare._chip_smoke()
    skn = cs.skn
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for shape, (ids, n_seg) in torch.load(compare.B2_OPERANDS).items():
        lay = skn.build_segment_layout(ids, n_seg, dev)
        data = torch.randn(lay.n, generator=gen, device=dev)
        want = skn.segment_max_plain(lay, data).view(torch.int32)
        fns = calls(libs, lay, data)
        bound = cs.segmax_bound_ms(lay)[0]
        equal = {}
        for name, fn in fns.items():
            a, b = fn(), fn()
            equal[name] = bool(torch.equal(a.view(torch.int32), want)
                               and torch.equal(b.view(torch.int32), want))
        ms = {name: [] for name in fns}
        for order in (VARIANTS, VARIANTS[::-1]):
            for name in order:
                ms[name].append(cs.device_ms(fns[name], bound))
        row = {"shape": shape, "b2": cs.b2_shape(lay), "bound_ms": bound, "ms": ms,
               "event_ms": {name: cs.time_ms(fn) for name, fn in fns.items()},
               "equal_plain_twice": equal}
        print(json.dumps(row), flush=True)
        rows.append(row)
    card = cs.card_line()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "b2_variants.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card, flush=True)
    if not all(all(r["equal_plain_twice"].values()) for r in rows):
        raise SystemExit("chip_b2_variants: a variant differs from segment_max_plain")
    return 0


if __name__ == "__main__":
    sys.exit(main())

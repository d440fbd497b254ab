// B2: fused threshold + pack + quantize of rfft spectrum rows.
//
// Replaces the TPU kernel repro/kernels/fused_compress.py::fused_compress_pallas
// (pl.pallas_call at l.168): per row, the Hermitian-weighted magnitude
// sqrt(re^2 + im^2) * w, the mask mag >= tau (the caller's per-row tau: the
// threshold kernel's, moved to mid-gap), index-ascending compaction of the
// kept bins into k_pad = ceil128(k) slots, and range-quant encode of re and
// im with the row's (eps, P, n_neg).  Slots never filled hold code 0 at
// index 0, as in the reference.
//
// Bound on this card: read re and im once (8 B per bin) and write the
// payload (2 code planes + int32 index: 6 B per slot, 3.75 KB per row at
// k_pad = 640): about 4.4 GB at 221,184 rows of 2049, so about 1.3 ms at
// 3.35 TB/s.  The encode (two logf, one expf, two IEEE divisions: ~100
// instructions a value) is the largest instruction cost.  The TPU kernel
// compacts with a one-hot contraction because a TPU has no cheap scatter;
// here a scatter into shared memory is cheap.
//
// Design: one CTA of 256 threads per row, in three phases with two barriers.
// 1. Warp w owns the contiguous columns [w*S, (w+1)*S), S = 32*J; lane l
//    holds columns w*S + 32j + l (j < J) in registers, so every load is one
//    coalesced line.  Columns past 8*S (2048 of 2049, 1024 of 1025) are the
//    tail, which warp 7, whose columns are the highest, takes in rounds of
//    32.  A ballot per item counts the warp's kept bins; a bit per item
//    remembers which of the lane's bins are kept.  Nothing leaves the warp.
// 2. One exclusive scan of the 8 warp counts through shared memory gives
//    each warp its base; the warp then walks its items again, and a ballot
//    per item gives each kept bin slot = base + kept bins at lower columns
//    of the warp: the number of kept bins at lower columns of the row, as
//    the plain version's cumsum.  Each kept bin with slot < k_pad writes
//    (re, im, column) to shared memory at its slot.
// 3. After the second barrier every thread encodes 4 consecutive slots with
//    converged lanes (the row's quantizer constants computed once) and
//    writes them as one 4- or 8-byte word per plane and one 16-byte index
//    word; slots past the kept count get code 0 at index 0 in the same pass.
// The magnitude and the quantizer run with explicit round-to-nearest
// intrinsics, so codes and indices are bitwise equal to the plain version.
// tests/test_torch_compress_threshold_design.py walks phases 1 and 2 in
// numpy; the two change together.
//
// With no tau (the reference's tau=None: fused_compress.py l.64-71), a
// separate instantiation (kBisect) finds each row's tau for k_keep itself,
// bitwise B1's (threshold.cuh bisect_row), with all eight warps.  It is
// bound by instruction issue and by each row's chain of barriers more than
// by bytes (tools/b2_bisect_phases.py reads where a row's cycles go), so
// the selection is built to issue little and to hold few registers, for 6
// CTAs a SM:
// a. Every thread loads its stretch columns once, the row's loads before
//    any arithmetic, stages re and im in shared memory for phase 2 and
//    keeps the weighted magnitudes in registers, plus one tail column's
//    (8 S + thread, -inf past the row), so the tail counts in every sweep.
// b. count(>= 0), and the maximum as the largest bit pattern taken as a
//    signed integer: the float maximum, or a NaN of the row (the card's
//    NaN, 0x7fffffff, lies above +inf; B2's magnitudes hold no other);
//    rows with no value of clear sign bit take B1's fmaxf.  hi =
//    upper_bracket(max) as B1's.
// c. B1's sweeps counted by the CTA: a compare an item, a warp reduction,
//    the warp's count to one of two shared slot sets in turn (a barrier a
//    sweep), and every thread sums the 8, so lo and hi are the same in
//    every thread; until at most kCtaCand (512) values lie in [lo, hi)
//    with B1's conditions on the bracket (by sweep 4 on spectrum rows).
//    Rows that never get there (all-zero rows after 1 sweep, NaN or +inf
//    maxima after 2, ties past 512) sweep to B1's fixed point: tau is lo.
// d. Those values go to shared memory in any order (a thread holding some
//    takes their slots with one shared atomic).
// e. B1's sweeps go on over them, two a thread, count(>= mid) = count(>= hi
//    at d) + the candidates >= mid, until at most kRankAt (32) are left (by
//    5 more sweeps).
// f. Those go to warp 0, one a lane, which takes v_k, the k-th largest
//    non-NaN magnitude, as the (k - count(>= hi))-th largest of them (-inf
//    when there are fewer).  count(>= mid) >= k exactly when v_k >= mid, so
//    B1's remaining sweeps are replayed from v_k with no count at all: mid
//    = 0.5 * (lo + hi) in round-to-nearest, feasible = v_k >= mid, the same
//    fixed-point stop (about 18 steps on spectrum rows).  One barrier hands
//    tau to the CTA.
// Phases 1-3 then run as above, the keep test on the magnitudes in
// registers, phase 2 taking re and im from the staged copy, phase 3
// encoding one plane at a time (the registers of 6 CTAs a SM hold one
// plane's codes, not both).  Its parameters follow the tau-given kernel's,
// and its code sits in `if constexpr` branches, so that instantiation's
// code is unchanged.  tests/test_torch_compress_threshold_design.py walks
// a-f in numpy.
#include <climits>

#include "range_quant.cuh"
#include "threshold.cuh"

namespace repro {

constexpr int kSlotGroup = 4;  // slots a thread encodes and stores at once

// kSlotGroup float-carried codes as one store word, each converted to CodeT
// as a single code store would convert it
template <typename CodeT> struct CodeWord;
template <> struct CodeWord<uint8_t> {
  using type = uint32_t;
  __device__ static uint32_t code(float c) { return static_cast<uint8_t>(c); }
  __device__ static type pack(const float (&c)[kSlotGroup]) {
    return code(c[0]) | (code(c[1]) << 8) | (code(c[2]) << 16) | (code(c[3]) << 24);
  }
};
template <> struct CodeWord<uint16_t> {
  using type = uint2;
  __device__ static uint32_t code(float c) { return static_cast<uint16_t>(c); }
  __device__ static type pack(const float (&c)[kSlotGroup]) {
    return make_uint2(code(c[0]) | (code(c[1]) << 16), code(c[2]) | (code(c[3]) << 16));
  }
};

// Hermitian-weighted magnitude, as the plain version rounds it.
__device__ __forceinline__ float weighted_mag(float re, float im, float w) {
  return __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im))), w);
}

// The kBisect selection's items a thread holds: its J stretch columns and
// one tail column (none at J = 16: rows are at most 4096 wide).
__host__ __device__ constexpr int bisect_items(int j) { return j < kMaxItems ? j + 1 : j; }

constexpr int kCtaCand = 2 * kThreads;  // values in [lo, hi) the CTA sweeps alone: two a thread
constexpr int kRankAt = 32;              // values in [lo, hi) warp 0 ranks: one a lane

// Built with -DREPRO_PHASE_CLOCKS (tools/b2_bisect_phases.py), thread 0 of
// every kBisect CTA adds clock64() at each of kPhaseStamps points of its row
// to g_phase_clocks[point]; the differences of the sums over the rows are
// the cycles the rows spent between the points.  Without the macro the
// stamps compile to nothing.
constexpr int kPhaseStamps = 9;
#ifdef REPRO_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[kPhaseStamps];
__device__ __forceinline__ void phase_stamp(int first, int last) {
  if (threadIdx.x == 0) {
    const unsigned long long now = clock64();
    for (int i = first; i <= last; ++i) atomicAdd(&g_phase_clocks[i], now);
  }
}
#else
__device__ __forceinline__ void phase_stamp(int, int) {}
#endif

// count(v >= t) over a thread's N items (a NaN compares false).
template <int N>
__device__ __forceinline__ int thread_count_ge(const float (&v)[N], float t) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) c += v[j] >= t ? 1 : 0;
  return c;
}

// Shared memory through 32-bit addresses: left to itself the compiler
// rebuilds a generic address (the cluster id and four more instructions)
// at every access in the sweep loops.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void st_shared(unsigned addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ float ld_shared(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
// The sum of the 8 ints at addr, in the same order in every thread.
__device__ __forceinline__ int ld_shared_sum8(unsigned addr) {
  int a, b, c, d, e, f, g, h;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(a), "=r"(b), "=r"(c), "=r"(d) : "r"(addr) : "memory");
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(e), "=r"(f), "=r"(g), "=r"(h) : "r"(addr + 16) : "memory");
  return ((a + b) + (c + d)) + ((e + f) + (g + h));
}

// B1's bracket state, the same in every thread, and B1's update from
// count(>= mid) (true at the fixed point, where lo is tau).  count(>= hi)
// is known where hi_count >= 0: until a sweep sets it, a hi at or below
// the maximum carries kUnknown, so lo_count - hi_count exceeds every cap.
struct Bracket {
  static constexpr int kUnknown = INT_MIN / 2;
  float lo, hi;
  int lo_count, hi_count;  // count(>= lo), count(>= hi)
  int it;                  // sweeps so far
  __device__ float mid() const { return __fmul_rn(0.5f, __fadd_rn(lo, hi)); }
  __device__ bool sweep(float mid, int c, int k) {
    const bool feasible = c >= k;
    const float moved = feasible ? lo : hi;  // the end mid replaces
    lo = feasible ? mid : lo;
    lo_count = feasible ? c : lo_count;
    hi = feasible ? hi : mid;
    hi_count = feasible ? hi_count : c;
    ++it;
    return __float_as_uint(mid) == __float_as_uint(moved);
  }
  // B1's condition for counting the values in [lo, hi) alone, with at most
  // ``cap`` of them: count(>= hi) known, lo <= mid <= hi, lo + hi finite
  __device__ bool fits(int cap) const {
    return (lo_count - hi_count <= cap) & (lo <= hi) & (fabsf(lo) <= kMaxBracket) &
           (fabsf(hi) <= kMaxBracket);
  }
};

// The kBisect row selection (the header's steps b-f) over the N items each
// thread holds in ``v`` (-inf where it holds no column): B1's tau for k,
// the same in every thread.  Every branch that holds a barrier depends on
// values that are the same in every thread.
template <int N>
__device__ __forceinline__ float cta_bisect(const float (&v)[N], int k, int iters) {
  __shared__ __align__(16) int s_count[2][kWarps];  // warp counts, two sweeps in turn
  __shared__ __align__(16) int s_max[kWarps];
  __shared__ float s_fmax[kWarps];  // B1's warp maxima, where every value is negative
  __shared__ float s_cand[kCtaCand];
  __shared__ __align__(16) float s_rank[kRankAt];
  __shared__ int s_n[2];  // values written to s_cand, to s_rank
  __shared__ float s_tau;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // b. count(>= 0), and the maximum as the largest bit pattern taken as a
  // signed integer: the float maximum where a value has its sign bit clear,
  // a NaN of the row where there is one (the card's NaN, 0x7fffffff, lies
  // above +inf, and B2's magnitudes hold no other)
  int imax = INT_MIN;
#pragma unroll
  for (int j = 0; j < N; ++j) imax = max(imax, __float_as_int(v[j]));
  imax = __reduce_max_sync(kFullMask, imax);
  const int c_zero = __reduce_add_sync(kFullMask, thread_count_ge<N>(v, 0.0f));
  if (lane == 0) {
    s_count[0][warp] = c_zero;
    s_max[warp] = imax;
  }
  if (threadIdx.x < 2) s_n[threadIdx.x] = 0;
  s_cand[threadIdx.x] = -INFINITY;  // past the candidates
  s_cand[threadIdx.x + kThreads] = -INFINITY;
  if (threadIdx.x < kRankAt) s_rank[threadIdx.x] = -INFINITY;
  __syncthreads();
  phase_stamp(2, 2);
  {
    const int4 a = reinterpret_cast<const int4*>(s_max)[0];
    const int4 b = reinterpret_cast<const int4*>(s_max)[1];
    imax = max(max(max(a.x, a.y), max(a.z, a.w)), max(max(b.x, b.y), max(b.z, b.w)));
  }
  float m = __int_as_float(imax);
  if (imax < 0) {  // every value negative: B1's fmaxf, a NaN of the row kept
    float fm = -INFINITY, nan = 0.0f;
    bool has_nan = false;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      fm = fmaxf(fm, v[j]);
      if (v[j] != v[j]) {
        has_nan = true;
        nan = v[j];
      }
    }
    fm = warp_max_keep_nan(fm, has_nan, nan);
    if (lane == 0) s_fmax[warp] = fm;
    __syncthreads();
    m = s_fmax[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) {
      const float x = s_fmax[i];
      m = m != m ? m : x != x ? x : fmaxf(m, x);
    }
  }

  // c. B1's sweeps, counted by the CTA, until at most kCtaCand values are
  // left in the bracket
  const unsigned counts = shared_addr(&s_count[0][0]);
  const float hi0 = upper_bracket(m);
  Bracket b{0.0f, hi0, ld_shared_sum8(counts), hi0 > m ? 0 : Bracket::kUnknown, 0};
  unsigned buf = counts;  // the slot set of the last sweep
  while (b.it < iters && !b.fits(kCtaCand)) {
    const float mid = b.mid();
    const int cw = __reduce_add_sync(kFullMask, thread_count_ge<N>(v, mid));
    buf ^= sizeof(s_count[0]);  // the other slot set
    if (lane == 0) st_shared(buf + 4 * warp, cw);
    __syncthreads();
    if (b.sweep(mid, ld_shared_sum8(buf), k)) {  // the fixed point
      phase_stamp(3, 5);
      return b.lo;
    }
  }
  phase_stamp(3, b.it == iters ? 5 : 3);
  if (b.it == iters) return b.lo;

  // d. the n = lo_count - hi_count values in [lo, hi) to shared memory, in
  // any order: a thread holding some takes their slots with one atomic
  unsigned in_bracket = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) in_bracket |= v[j] >= b.lo && v[j] < b.hi ? 1u << j : 0u;
  int slot = 0;
  if (in_bracket) slot = atomicAdd(&s_n[0], __popc(in_bracket));
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if ((in_bracket >> j) & 1u) s_cand[slot++] = v[j];
  }
  __syncthreads();
  phase_stamp(4, 4);

  // e. B1's sweeps over the candidates, two a thread (-inf past them), plus
  // count(>= hi) at d, until at most kRankAt are left
  const unsigned cand = shared_addr(s_cand + threadIdx.x);
  const int below_hi = b.hi_count;
  while (b.it < iters && b.lo_count - b.hi_count > kRankAt) {
    const float mid = b.mid();
    const int mine =
        (ld_shared(cand) >= mid ? 1 : 0) + (ld_shared(cand + 4 * kThreads) >= mid ? 1 : 0);
    const int cw = __reduce_add_sync(kFullMask, mine);
    buf ^= sizeof(s_count[0]);
    if (lane == 0) st_shared(buf + 4 * warp, cw);
    __syncthreads();
    if (b.sweep(mid, below_hi + ld_shared_sum8(buf), k)) {
      phase_stamp(5, 5);
      return b.lo;
    }
  }
  if (b.it == iters) {
    phase_stamp(5, 5);
    return b.lo;
  }
  {  // the values left in [lo, hi) to s_rank, in any order
    const float c0 = ld_shared(cand), c1 = ld_shared(cand + 4 * kThreads);
    const bool in0 = c0 >= b.lo && c0 < b.hi, in1 = c1 >= b.lo && c1 < b.hi;
    if (in0 || in1) {
      int at = atomicAdd(&s_n[1], in0 + in1);
      if (in0) s_rank[at++] = c0;
      if (in1) s_rank[at] = c1;
    }
  }
  __syncthreads();
  phase_stamp(5, 5);

  // f. warp 0: v_k by rank, one candidate a lane, then the rest of B1's
  // sweeps replayed from v_k (lo <= mid <= hi are finite: v_k = +inf for
  // k <= 0, -inf when it lies below lo)
  if (warp == 0) {
    const int n = b.lo_count - b.hi_count;
    const float x = s_rank[lane];
    int ge = 0;  // candidates >= x (not the -inf past n)
#pragma unroll
    for (int i = 0; i < kRankAt / 4; ++i) {
      const float4 c = reinterpret_cast<const float4*>(s_rank)[i];
      ge += (c.x >= x ? 1 : 0) + (c.y >= x ? 1 : 0) + (c.z >= x ? 1 : 0) + (c.w >= x ? 1 : 0);
    }
    // the r-th largest is the largest candidate with at least r at or above
    // it; candidates lie in [lo, hi) with lo >= 0, so after -0 -> +0 their
    // bits order them
    const int r = k - b.hi_count;  // v_k's rank among the candidates
    const bool sel = lane < n && ge >= r;
    const unsigned key = sel ? __float_as_uint(__fadd_rn(x, 0.0f)) : 0u;
    const unsigned best = __reduce_max_sync(kFullMask, key);
    const bool any = __ballot_sync(kFullMask, sel) != 0u;
    const float vk = r <= 0 ? INFINITY : any ? __uint_as_float(best) : -INFINITY;
    float lo = b.lo, hi = b.hi;
    for (int it = b.it; it < iters; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      const bool feasible = vk >= mid;  // count(>= mid) >= k
      const float moved = feasible ? lo : hi;
      lo = feasible ? mid : lo;
      hi = feasible ? hi : mid;
      if (__float_as_uint(mid) == __float_as_uint(moved)) break;
    }
    if (lane == 0) s_tau = lo;
  }
  __syncthreads();
  return s_tau;
}

// J: items per lane in the warps' stretches (cols / 256, 0..16).  Dynamic
// shared memory: k_pad floats of re, k_pad of im, k_pad column ints (with
// kBisect, then the stretch's re and im, 2 * 256 J floats).  The CTAs per
// SM are stated: 6 (40 registers) up to 2303 columns, which the load of the
// quantizer params after the first barrier makes room for, and 3 above;
// left to itself, ptxas picks 48 or 64 registers for the wider rows and
// spills.  The bisecting instantiations fit the same budgets by staging re
// and im, loading the weights beside the arithmetic and encoding one plane
// at a time (a variant at 5 CTAs a SM ran 8% slower: PERF.md).
template <int J, typename CodeT, bool kBisect>
__global__ void __launch_bounds__(kThreads, J > 8 ? 3 : 6)
fused_compress_kernel(const float* __restrict__ re, const float* __restrict__ im,
                      const float* __restrict__ w, const float* __restrict__ tau_in,
                      const float* __restrict__ eps, const float* __restrict__ p_codes,
                      const float* __restrict__ n_neg, int cols, int k_pad, float m_scale,
                      CodeT* __restrict__ rec, CodeT* __restrict__ imc,
                      int* __restrict__ idx, int k_keep, int iters,
                      float* __restrict__ tau_out) {
  extern __shared__ float4 smem[];
  __shared__ int warp_kept[kWarps];
  float* s_re = reinterpret_cast<float*>(smem);
  float* s_im = s_re + k_pad;
  int* s_col = reinterpret_cast<int*>(s_im + k_pad);
  // kBisect: the stretch's re, then im, staged for phase 2 (item j of thread
  // t at j * kThreads + t), so they hold no registers through the selection
  [[maybe_unused]] float* stage = reinterpret_cast<float*>(s_col + k_pad);

  const size_t row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
  const float* re_row = re + row * cols;
  const float* im_row = im + row * cols;
  constexpr int kItems = J > 0 ? J : 1;  // rows under 256 columns are all tail
  float vre[kItems], vim[kItems];
  [[maybe_unused]] float mag[bisect_items(J)];  // kBisect: the weighted magnitudes
  float tau;
  if constexpr (kBisect) {
    phase_stamp(0, 0);
    // the row's loads before any arithmetic: a sqrtf's slow-path branch
    // between them would hold the later ones back (the weights, which every
    // CTA reads, come from the cache)
    const int col0 = warp * 32 * J + lane;
    const int col = kWarps * 32 * J + threadIdx.x;  // the tail column
    float t_re = 0.0f, t_im = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      vre[j] = re_row[col0 + 32 * j];
      vim[j] = im_row[col0 + 32 * j];
    }
    if (J < kMaxItems && col < cols) {
      t_re = re_row[col];
      t_im = im_row[col];
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      mag[j] = weighted_mag(vre[j], vim[j], w[col0 + 32 * j]);
      stage[j * kThreads + threadIdx.x] = vre[j];
      stage[(J + j) * kThreads + threadIdx.x] = vim[j];
    }
    if constexpr (J < kMaxItems)
      mag[J] = col < cols ? weighted_mag(t_re, t_im, w[col]) : -INFINITY;
    phase_stamp(1, 1);
    tau = cta_bisect<bisect_items(J)>(mag, k_keep, iters);
    phase_stamp(6, 6);
    if (threadIdx.x == 0) tau_out[row] = tau;
  } else {
    tau = tau_in[row];
  }
  constexpr int kStretch = 32 * J;
  const int first = warp * kStretch + lane;
  const int tail0 = kWarps * kStretch;  // first tail column
  const bool tail_warp = warp == kWarps - 1;

  // phase 1: the warp's stretch in registers; bit j of keep_bits marks
  // item j kept; the warp's count of kept bins
  if constexpr (!kBisect) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      vre[j] = re_row[first + 32 * j];
      vim[j] = im_row[first + 32 * j];
    }
  }
  unsigned keep_bits = 0;
  int kept = 0;  // the warp's kept bins so far (the same in every lane)
#pragma unroll
  for (int j = 0; j < J; ++j) {
    bool keep;
    if constexpr (kBisect)
      keep = mag[j] >= tau;
    else
      keep = weighted_mag(vre[j], vim[j], w[first + 32 * j]) >= tau;
    keep_bits |= static_cast<unsigned>(keep) << j;
    kept += __popc(__ballot_sync(kFullMask, keep));
  }
  if (tail_warp) {
    for (int col = tail0 + lane; col - lane < cols; col += 32) {
      const bool keep = col < cols && weighted_mag(re_row[col], im_row[col], w[col]) >= tau;
      kept += __popc(__ballot_sync(kFullMask, keep));
    }
  }

  // phase 2: one exclusive scan of the warp counts, then the kept bins to
  // their slots in shared memory
  if (lane == 0) warp_kept[warp] = kept;
  __syncthreads();
  const float e = eps[row], p = p_codes[row], nn = n_neg[row];  // for phase 3
  int base = 0, total = 0;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) {
    const int c = warp_kept[wi];
    base += wi < warp ? c : 0;
    total += c;
  }
  int slot0 = base;  // slot of the warp's next kept bin
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bool keep = (keep_bits >> j) & 1u;
    const unsigned ballot = __ballot_sync(kFullMask, keep);
    const int slot = slot0 + __popc(ballot & below);
    if (keep && slot < k_pad) {
      if constexpr (kBisect) {
        s_re[slot] = stage[j * kThreads + threadIdx.x];
        s_im[slot] = stage[(J + j) * kThreads + threadIdx.x];
      } else {
        s_re[slot] = vre[j];
        s_im[slot] = vim[j];
      }
      s_col[slot] = first + 32 * j;
    }
    slot0 += __popc(ballot);
  }
  if (tail_warp) {
    for (int col = tail0 + lane; col - lane < cols && slot0 < k_pad; col += 32) {
      float t_re = 0.0f, t_im = 0.0f;
      bool keep = false;
      if (col < cols) {
        t_re = re_row[col];
        t_im = im_row[col];
        keep = weighted_mag(t_re, t_im, w[col]) >= tau;
      }
      const unsigned ballot = __ballot_sync(kFullMask, keep);
      const int slot = slot0 + __popc(ballot & below);
      if (keep && slot < k_pad) {
        s_re[slot] = t_re;
        s_im[slot] = t_im;
        s_col[slot] = col;
      }
      slot0 += __popc(ballot);
    }
  }
  __syncthreads();
  if constexpr (kBisect) phase_stamp(7, 7);

  // phase 3: dense encode of the filled slots, wide stores, zero tail
  const int filled = min(total, k_pad);
  const EncodeRow q = encode_row(e, p, nn);
  using Word = typename CodeWord<CodeT>::type;
  Word* rec_row = reinterpret_cast<Word*>(rec + row * k_pad);
  Word* imc_row = reinterpret_cast<Word*>(imc + row * k_pad);
  int4* idx_row = reinterpret_cast<int4*>(idx + row * k_pad);
  if constexpr (kBisect) {
    // the same words, one plane at a time: at 6 CTAs a SM the registers
    // hold one plane's codes, not both
    for (int g = threadIdx.x; g < k_pad / kSlotGroup; g += kThreads) {
      const int s0 = g * kSlotGroup;
#pragma unroll 1
      for (int plane = 0; plane < 2; ++plane) {
        float c[kSlotGroup] = {};
        if (s0 < filled) {
          const float4 v4 = reinterpret_cast<const float4*>(plane ? s_im : s_re)[g];
          const float v[kSlotGroup] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int u = 0; u < kSlotGroup; ++u)
            if (s0 + u < filled) c[u] = encode_value(v[u], q, m_scale);
        }
        (plane ? imc_row : rec_row)[g] = CodeWord<CodeT>::pack(c);
      }
      int4 cols4 = make_int4(0, 0, 0, 0);
      if (s0 < filled) {
        const int4 k4 = reinterpret_cast<const int4*>(s_col)[g];
        cols4 = make_int4(k4.x, s0 + 1 < filled ? k4.y : 0, s0 + 2 < filled ? k4.z : 0,
                          s0 + 3 < filled ? k4.w : 0);
      }
      idx_row[g] = cols4;
    }
  } else {
    for (int g = threadIdx.x; g < k_pad / kSlotGroup; g += kThreads) {
      const int s0 = g * kSlotGroup;
      float c_re[kSlotGroup] = {}, c_im[kSlotGroup] = {};
      int4 cols4 = make_int4(0, 0, 0, 0);
      if (s0 < filled) {
        const float4 r4 = reinterpret_cast<const float4*>(s_re)[g];
        const float4 i4 = reinterpret_cast<const float4*>(s_im)[g];
        const int4 k4 = reinterpret_cast<const int4*>(s_col)[g];
        const float r[kSlotGroup] = {r4.x, r4.y, r4.z, r4.w};
        const float i[kSlotGroup] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
        for (int u = 0; u < kSlotGroup; ++u) {
          if (s0 + u < filled) {
            c_re[u] = encode_value(r[u], q, m_scale);
            c_im[u] = encode_value(i[u], q, m_scale);
          }
        }
        cols4 = make_int4(k4.x, s0 + 1 < filled ? k4.y : 0, s0 + 2 < filled ? k4.z : 0,
                          s0 + 3 < filled ? k4.w : 0);
      }
      rec_row[g] = CodeWord<CodeT>::pack(c_re);
      imc_row[g] = CodeWord<CodeT>::pack(c_im);
      idx_row[g] = cols4;
    }
  }
  if constexpr (kBisect) phase_stamp(8, 8);
}

// Launches the instantiation with J = cols / 256 items per lane (0..16;
// rows up to 4096 wide); with kBisect, the one that bisects for k_keep and
// writes its tau to tau_out.
template <typename CodeT, bool kBisect, int J = 0>
int launch(const float* re, const float* im, const float* w, const float* tau_in,
           const float* eps, const float* p_codes, const float* n_neg, int rows, int cols,
           int k_pad, float m_scale, void* rec, void* imc, int* idx, int k_keep, int iters,
           float* tau_out, cudaStream_t s) {
  if constexpr (J < kMaxItems) {
    if (cols / kThreads != J)
      return launch<CodeT, kBisect, J + 1>(re, im, w, tau_in, eps, p_codes, n_neg, rows, cols,
                                           k_pad, m_scale, rec, imc, idx, k_keep, iters,
                                           tau_out, s);
  }
  if (cols < 1 || cols > kThreads * kMaxItems || k_pad % (32 * kSlotGroup))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_compress_kernel<J, CodeT, kBisect>;
  const size_t smem =
      (static_cast<size_t>(k_pad) * 3 + (kBisect ? 2 * J * kThreads : 0)) * sizeof(float);
  if (kBisect || smem > 48 * 1024) {  // kBisect's static shared memory counts too
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<rows, kThreads, smem, s>>>(re, im, w, tau_in, eps, p_codes, n_neg, cols, k_pad,
                                      m_scale, static_cast<CodeT*>(rec),
                                      static_cast<CodeT*>(imc), idx, k_keep, iters, tau_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// code_bytes is 1 (uint8 codes, n_bits <= 8) or 2 (uint16); k_pad is a
// multiple of 128.
REPRO_EXPORT int fused_compress(const float* re, const float* im, const float* w,
                                const float* tau_in, const float* eps, const float* p_codes,
                                const float* n_neg, int rows, int cols, int k_pad, float m_scale,
                                int code_bytes, void* rec, void* imc, int* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return repro::launch<uint8_t, false>(re, im, w, tau_in, eps, p_codes, n_neg, rows, cols,
                                         k_pad, m_scale, rec, imc, idx, 0, 0, nullptr, s);
  if (code_bytes == 2)
    return repro::launch<uint16_t, false>(re, im, w, tau_in, eps, p_codes, n_neg, rows, cols,
                                          k_pad, m_scale, rec, imc, idx, 0, 0, nullptr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same with no tau: each row bisected for k_keep in ``iters`` sweeps
// (B1's routine); tau_out (rows,) receives it.
REPRO_EXPORT int fused_compress_bisect(const float* re, const float* im, const float* w,
                                       const float* eps, const float* p_codes,
                                       const float* n_neg, int rows, int cols, int k_pad,
                                       float m_scale, int code_bytes, void* rec, void* imc,
                                       int* idx, int k_keep, int iters, float* tau_out,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return repro::launch<uint8_t, true>(re, im, w, nullptr, eps, p_codes, n_neg, rows, cols,
                                        k_pad, m_scale, rec, imc, idx, k_keep, iters, tau_out, s);
  if (code_bytes == 2)
    return repro::launch<uint16_t, true>(re, im, w, nullptr, eps, p_codes, n_neg, rows, cols,
                                         k_pad, m_scale, rec, imc, idx, k_keep, iters, tau_out,
                                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef REPRO_PHASE_CLOCKS
// The kBisect kernel's clock sums (kPhaseStamps of them) to ``out`` and back
// to 0 on the device.
REPRO_EXPORT int fused_compress_phase_clocks(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, repro::g_phase_clocks, sizeof(repro::g_phase_clocks));
  if (err == cudaSuccess) {
    const unsigned long long zero[repro::kPhaseStamps] = {};
    err = cudaMemcpyToSymbol(repro::g_phase_clocks, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif

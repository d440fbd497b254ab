"""The per-row algorithms of kernels B2 (``csrc/fused_compress.cu``), B6a
(``pack`` in ``csrc/pack.cu``), B4 (``csrc/sampled_threshold.cu``) and B1
(``csrc/topk_threshold.cu``), transcribed into numpy and walked on the CPU,
where no CUDA kernel runs.  Each walk is held bitwise to the plain PyTorch
version that the kernel's wrapper runs on a CPU tensor, and that the kernel
is held to on the card.

B2, one CTA of 256 threads (8 warps of 32 lanes) per row:

* phase 1: warp w owns the contiguous columns [w*S, (w+1)*S), S = 32*J,
  J = min(cols // 256, 16); lane l holds w*S + 32j + l for j < J.  The tail
  [8*S, cols) belongs to warp 7, in rounds of 32.  A ballot per item counts
  the warp's kept bins; a bit per item and lane marks the kept ones;
* phase 2: an exclusive scan of the 8 warp counts gives each warp its base;
  the warp walks its items again, a ballot per item ranking each kept bin
  after the warp's kept bins at lower columns; a kept bin with slot < k_pad
  goes to shared memory at its slot (the tail after the warp's main items);
* phase 3: thread t takes the groups of 4 slots g = t, t + 256, ...; slots
  under min(count, k_pad) are encoded, the rest get code 0 at index 0.

B6a runs phases 1 and 2 of B2 on keep = |x| >= tau (the same column map and
scan, so the same walk), and in phase 3 copies the values and columns of
the filled slots, (0.0, 0) past the count.

B4, one warp per row: lane l holds sample values l, l + 32, ... (the
columns offset + stride * i of the strided sample, -inf past s) and the
row's columns l + 32j, j < N (N = ceil(cols/32) when that is 8g + 1, else
rounded up to a multiple of 8; -inf past the row).  The sample's two rank
bisections on [0, upper_bracket(sample max)] give the estimates hi (rank
hi_rank) and lo (rank lo_rank), each its lo; each counts by a ballot and
a popc per item a lane, and both stop at the first sweep that moves
neither bracket.  One pass
counts >= lo and >= hi (packed into one integer for one warp sum) and
takes the maximum (a NaN of the row, bits and all, if there is one); the
clamp, then 16 sweeps of mid = 0.5 * (lo + hi)
in float32, carrying count(>= lo) so the final count needs no pass.  After
5 sweeps each lane keeps its values in [lo, hi) (at most 8, else the row
goes on sweeping in full), and the last 11 sweeps count them alone, plus
count(>= hi).  Last, the mid-gap: the maximum of v < tau_k (else 0) over
the lanes' items, and tau = 0.5 * (tau_k + that).

B1, one warp per row, lane l holding columns l + 32j as B4: one pass counts
>= 0 and takes the maximum as B4 does; lo = 0, hi = upper_bracket(max), and
count(>= hi) is known to be 0 where hi lies above the maximum.  The sweeps
carry count(>= lo) and count(>= hi); at the first sweep where at most
COMPACT_AT values lie in [lo, hi) (and the bracket allows B4's proof) the
warp compacts them, in lane order, into 2 registers a lane, and the later
sweeps count those plus count(>= hi).  The loop stops after the first
sweep that leaves lo and hi as they were, bit for bit: every later sweep
would repeat it.

B2 with ``tau=None`` selects with the whole CTA: thread t = 32 w + l holds
its J stretch magnitudes and one tail column, 8 S + t (-inf past the row;
none at J = 16).  count(>= 0) is a warp reduction summed over the warps,
the maximum the largest bit pattern as a signed integer (B1's fmaxf where
no value has its sign bit clear); then B1's sweeps run CTA-wide, each warp
counting its items, until at most 512 values lie in [lo, hi) with B1's
conditions on the bracket.  Rows that never get there sweep to B1's fixed
point.  The others write those values to 512 shared slots (in whatever
order the threads' atomics land), the sweeps go on over them, two a
thread, until at most 32 are left, warp 0 takes them one a lane and finds
v_k, the k-th largest non-NaN value of the row, as the (k - count(>= hi))-th
largest, and replays the rest of B1's sweeps with ``v_k >= mid`` in place
of ``count(>= mid) >= k``: the two agree for every mid (the replay lemma),
so the tau is B1's.

``csrc/fused_compress.cu``, ``csrc/pack.cu``, ``csrc/sampled_threshold.cu``,
``csrc/topk_threshold.cu`` and ``csrc/threshold.cuh`` name this file: they
change together.
"""

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import selection
from repro_torch.core import sparsify
from repro_torch.core.quantizer import RangeQuantConfig, fit_quantizer
from repro_torch.kernels import _checks
from repro_torch.kernels import fused_compress as tfc
from repro_torch.kernels import pack as tpk
from repro_torch.kernels import sampled_threshold as tst
from repro_torch.kernels import topk_threshold as ttt
from repro_torch.kernels.range_quant import encode_math

WARPS, LANES = 8, 32
THREADS = WARPS * LANES
GROUP = 4  # slots a B2 thread encodes and stores at once
LANE = np.arange(LANES)
WIDTHS = [2049, 1025, 513, 512, 300, 100]  # main path, chunk 2048, tests, odd tails
MAX_STRETCH = 16  # items a lane holds in a warp's stretch (rows 4096 wide)


# ---------------------------------------------------------------- B2


def stretch_load_map(cols):
    """Phase 1's loads of B2 and B6a: a list of (warp, column array of one
    warp instruction); the tail's rounds (warp 7) last."""
    j_items = min(cols // THREADS, MAX_STRETCH)
    stretch = LANES * j_items
    loads = [(w, w * stretch + LANES * j + LANE) for w in range(WARPS) for j in range(j_items)]
    loads += [(WARPS - 1, t + LANE) for t in range(WARPS * stretch, cols, LANES)]
    return loads


def compact_walk(keep, k_pad):
    """One row's phases 1-3 as B2 and B6a run them: (idx (k_pad,) int32,
    filled, the slots each phase-2 warp instruction writes)."""
    cols = keep.size
    j_items = min(cols // THREADS, MAX_STRETCH)
    stretch = LANES * j_items
    below = np.tril(np.ones((LANES, LANES), bool), -1)  # below[l, m]: m < l

    def ballot(cs):
        return (cs < cols) & keep[np.minimum(cs, cols - 1)]

    # phase 1: keep bits per lane and item, the warp's count
    keep_bits = np.zeros((WARPS, LANES), np.int64)
    kept = np.zeros(WARPS, np.int64)
    for w in range(WARPS):
        for j in range(j_items):
            b = ballot(w * stretch + LANES * j + LANE)
            keep_bits[w] |= b.astype(np.int64) << j
            kept[w] += b.sum()
    tail_rounds = list(range(WARPS * stretch, cols, LANES))
    for t in tail_rounds:
        kept[WARPS - 1] += ballot(t + LANE).sum()
    # phase 2: scan of the warp counts; each warp walks its items again
    base = np.concatenate([[0], np.cumsum(kept)[:-1]])
    total = int(kept.sum())
    s_col = np.full(k_pad, -1, np.int64)
    writes = []
    slot0 = base.copy()
    for w in range(WARPS):
        for j in range(j_items):
            b = ((keep_bits[w] >> j) & 1).astype(bool)
            slot = slot0[w] + (below & b[None, :]).sum(axis=1)
            ok = b & (slot < k_pad)
            s_col[slot[ok]] = (w * stretch + LANES * j + LANE)[ok]
            writes.append(slot[ok])
            slot0[w] += b.sum()
    slot0 = slot0[WARPS - 1]
    for t in tail_rounds:
        if slot0 >= k_pad:
            break
        cs = t + LANE
        b = ballot(cs)
        slot = slot0 + (below & b[None, :]).sum(axis=1)
        ok = b & (slot < k_pad)
        s_col[slot[ok]] = cs[ok]
        writes.append(slot[ok])
        slot0 += b.sum()
    # phase 3
    filled = min(total, k_pad)
    idx = np.zeros(k_pad, np.int32)
    for g in range(k_pad // GROUP):
        s0 = g * GROUP
        if s0 < filled:
            for u in range(GROUP):
                if s0 + u < filled:
                    idx[s0 + u] = s_col[s0 + u]
    return idx, filled, writes


def _planes(rows, cols, kind, seed):
    """(re, im, w, tau, k_keep) of ``rows`` rows of one kind, float32."""
    rng = np.random.default_rng(seed)
    re, im = (rng.standard_normal((2, rows, cols)) * 0.05).astype(np.float32)
    w = np.full(cols, 2.0, np.float32)
    w[0] = w[-1] = 1.0
    k = sparsify.keep_count(cols, 0.7)
    if kind == "ties":  # magnitudes on a coarse grid: many bins tie with tau
        re = np.round(re * 40).astype(np.float32) / np.float32(40)
        im = np.zeros_like(im)
    if kind == "zero":  # the stacked layout's padding rows
        re[:], im[:] = 0.0, 0.0
    mag = (np.sqrt(re * re + im * im) * w).astype(np.float32)
    if kind in ("zero", "over"):  # tau 0: every bin kept, cut at k_pad
        tau = np.zeros(rows, np.float32)
    elif kind == "few":  # 3 kept: most groups are the zero tail
        tau = -np.sort(-mag, axis=1)[:, 2]
    else:
        tau = -np.sort(-mag, axis=1)[:, k - 1]
    return re, im, w, tau.astype(np.float32), k


@pytest.mark.parametrize("cols", WIDTHS + [4096, 255, 1, 5000])
def test_b2_column_map_is_a_partition_in_ascending_warp_stretches(cols):
    """Every column is loaded once; each warp instruction reads 32
    consecutive columns (one coalesced span, clipped at the row's end in the
    tail); a warp's columns lie above every column of the warps before it,
    so the scan of warp counts gives index-ascending slots."""
    loads = stretch_load_map(cols)
    seen = np.concatenate([c[c < cols] for _, c in loads])
    np.testing.assert_array_equal(np.sort(seen), np.arange(cols))
    for _, c in loads:
        assert np.all(np.diff(c) == 1)
    top = -1
    for w in range(WARPS):
        cs = np.concatenate([c[c < cols] for ww, c in loads if ww == w] or [np.zeros(0, int)])
        if cs.size:
            assert cs.min() > top
            top = cs.max()


@pytest.mark.parametrize("kind", ["random", "zero", "over", "few", "ties"])
@pytest.mark.parametrize("cols", WIDTHS)
def test_b2_walk_equals_plain_cumsum_slots_and_codes(cols, kind):
    """The walk's slot -> column map, kept count and codes equal the plain
    version's (cumsum slots, truncation at k_pad, code 0 at index 0 past the
    count) bitwise; every phase-2 warp instruction writes distinct banks."""
    rows = 3
    re, im, w, tau, k = _planes(rows, cols, kind, seed=cols + len(kind))
    k_pad = tfc.pad_k(k)
    q = fit_quantizer(torch.tensor(float(min(re.min(), im.min(), -1e-3))),
                      torch.tensor(float(max(re.max(), im.max(), 1e-3))), RangeQuantConfig(8, 3))
    t = [torch.from_numpy(a) for a in (re, im, w, tau)]
    p_re, p_im, p_idx, _ = tfc.fused_compress_plain(*t[:3], q.eps, q.p_codes, t[3], k_keep=k)
    eps, p, n_neg = _checks.encode_row_params(q.eps, q.p_codes, 8, 1, "cpu")
    mag = (np.sqrt(re * re + im * im) * w).astype(np.float32)
    for r in range(rows):
        keep = mag[r] >= tau[r]
        idx, filled, writes = compact_walk(keep, k_pad)
        np.testing.assert_array_equal(idx, p_idx[r].numpy())
        assert filled == min(int(keep.sum()), k_pad)
        for plane, want in ((re, p_re), (im, p_im)):
            vals = torch.from_numpy(plane[r][idx[:filled]])
            codes = encode_math(vals, eps, p, n_neg, 8.0).to(torch.uint8)
            np.testing.assert_array_equal(codes.numpy(), want[r, :filled].numpy())
            assert not want[r, filled:].any()
        for slots in writes:
            assert len(set(slots % 32)) == len(slots)
        if kind in ("zero", "over"):
            np.testing.assert_array_equal(idx[:filled], np.arange(filled))


# ---------------------------------------------------------------- B4


FULL_SWEEPS, CAND_REGS = 5, 8  # B4's sweeps over the row, candidates a lane keeps
FLT_MAX = np.float32(np.finfo(np.float32).max)
MAX_BRACKET = FLT_MAX / np.float32(4)


def b4_items(cols):
    """Items per lane N of the kernel's dispatch."""
    items = -(-cols // LANES)
    return items if items % 8 == 1 else -(-items // 8) * 8


def _upper_bracket(x):
    """The kernel's upper_bracket: bits + 1, clamped to FLT_MAX unless NaN."""
    up = np.array([x], np.float32).view(np.uint32) + np.uint32(1)
    up = up.view(np.float32)[0]
    return up if np.isnan(up) else np.float32(min(up, FLT_MAX))


def lane_items(row):
    """The row as a warp holds it: (lane, item) float32, -inf past the row."""
    cols = row.size
    col = LANES * np.arange(b4_items(cols))[None, :] + LANE[:, None]
    v = np.where(col < cols, row[np.minimum(col, cols - 1)], np.float32(-np.inf))
    return v.astype(np.float32)


def lane_max(v):
    """warp_max_keep_nan over the lanes' items: the maximum, or the first
    NaN lane's last NaN, bits and all."""
    m = np.float32(np.fmax.reduce(v.ravel()))
    nan_lanes = np.flatnonzero(np.isnan(v).any(axis=1))
    if nan_lanes.size:
        lane_v = v[nan_lanes[0]]
        m = lane_v[np.flatnonzero(np.isnan(lane_v))[-1]]
    return m


def lane_count(v, t):
    """warp_count_ge: count(v >= t) in 4 accumulators."""
    parts = [int((v[:, j::4] >= t).sum()) for j in range(4)]
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def b4_sample_bracket(row, s, stride, offset, hi_rank, lo_rank, iters):
    """The sample's bracket as the warp runs it: (lo, hi, sweeps).  Lane l
    holds sample values i = l, l + 32, ... (columns offset + stride * i;
    -inf past s); each bisection counts by a ballot and a popc per item, and
    both stop at the first sweep that moves neither."""
    per_lane = -(-s // LANES)
    i = LANES * np.arange(per_lane)[None, :] + LANE[:, None]  # (lane, item)
    sv = np.where(i < s, row[offset + stride * np.minimum(i, s - 1)], np.float32(-np.inf))
    sv = sv.astype(np.float32)
    top = _upper_bracket(lane_max(sv))
    half = np.float32(0.5)
    lo_h, hi_h, lo_l, hi_l = np.float32(0.0), top, np.float32(0.0), top
    sweeps = 0
    with np.errstate(invalid="ignore", over="ignore"):
        for _ in range(iters):
            sweeps += 1
            mid_h = np.float32(half * np.float32(lo_h + hi_h))
            mid_l = np.float32(half * np.float32(lo_l + hi_l))
            # item j's ballot over the lanes, its popc, summed over the items
            c_h = sum(_popc(_ballot(sv[:, j] >= mid_h)) for j in range(per_lane))
            c_l = sum(_popc(_ballot(sv[:, j] >= mid_l)) for j in range(per_lane))
            feas_h, feas_l = c_h >= hi_rank, c_l >= lo_rank
            moved_h, moved_l = (lo_h if feas_h else hi_h), (lo_l if feas_l else hi_l)
            lo_h, hi_h = (mid_h, hi_h) if feas_h else (lo_h, mid_h)
            lo_l, hi_l = (mid_l, hi_l) if feas_l else (lo_l, mid_l)
            if _bits(mid_h) == _bits(moved_h) and _bits(mid_l) == _bits(moved_l):
                break
    return lo_l, lo_h, sweeps


def _ballot(pred):
    """__ballot_sync: bit l set where lane l's predicate holds."""
    return sum(1 << int(lane) for lane in np.flatnonzero(pred))


def _popc(mask):
    return bin(mask).count("1")


def _bits(x):
    return int(np.array([x], np.float32).view(np.uint32)[0])


def b4_walk(row, lo0, hi0, k, iters):
    """The clamp and the refine sweeps of one row as the warp runs them:
    (tau float32, count, whether the last sweeps ran over the candidates
    alone, whether the bracket fell back)."""
    v = lane_items(row)
    per_lane = (v >= lo0).sum(axis=1) | ((v >= hi0).sum(axis=1) << 16)
    both = int(per_lane.sum())
    c_lo, c_hi = both & 0xFFFF, both >> 16
    m = lane_max(v)

    def count(t):
        return lane_count(v, t)

    lo, hi, lo_count, hi_count, hi_known = np.float32(lo0), np.float32(hi0), c_lo, c_hi, True
    if c_lo < k:
        lo, lo_count = np.float32(0.0), count(np.float32(0.0))
    if c_hi >= k:
        hi, hi_count, hi_known = _upper_bracket(m), 0, bool(m < FLT_MAX)
    half = np.float32(0.5)
    cand = None  # None: sweep the full row
    with np.errstate(invalid="ignore", over="ignore"):  # a NaN hi makes every mid NaN
        for it in range(iters):
            if (it == FULL_SWEEPS and hi_known and lo <= hi and abs(lo) <= MAX_BRACKET
                    and abs(hi) <= MAX_BRACKET):
                inside = (v >= lo) & (v < hi)  # (lane, item)
                if inside.sum(axis=1).max() <= CAND_REGS:  # every lane's fit its registers
                    cand = v[inside]
            mid = np.float32(half * np.float32(lo + hi))
            if cand is not None:
                c = hi_count + int((cand >= mid).sum())
                assert c == count(mid)  # the identity the kernel relies on
            else:
                c = count(mid)
            if c >= k:
                lo, lo_count = mid, c
            else:
                hi = mid
                if cand is None:
                    hi_count, hi_known = c, True
    return lo, lo_count, cand is not None, c_lo < k or c_hi >= k


def b4_mid_gap(row, tau_k):
    """The kernel's mid-gap: the maximum over the lanes' items of v where v
    < tau_k, else 0, from -inf; then 0.5 * (tau_k + below)."""
    v = lane_items(row)
    below = np.float32(np.max(np.where(v < tau_k, v, np.float32(0.0))))
    with np.errstate(over="ignore"):
        return np.float32(np.float32(0.5) * np.float32(tau_k + below))


def b4_select_walk(row, k, sample_rate, seed, iters=selection.DEFAULT_REFINE_ITERS):
    """The whole launch for one row: (tau_k, count, tau, candidates alone,
    fell back, the sample's sweeps)."""
    cols = row.size
    s, stride, offset = selection._sample_layout(cols, sample_rate, seed)
    hi_rank, lo_rank = selection.sample_ranks(k, s, cols)
    lo0, hi0, sweeps = b4_sample_bracket(row, s, stride, offset, hi_rank, lo_rank,
                                         selection.BISECT_ITERS)
    tau_k, cnt, dense, fell = b4_walk(row, lo0, hi0, k, iters)
    return tau_k, cnt, b4_mid_gap(row, tau_k), dense, fell, sweeps


def _b4_case(cols, kind, seed, sample_rate):
    """(mag, k) for ``kind`` rows; ``lo_high`` and ``hi_low`` put values at
    the sample's columns that break one side of the bracket's invariant."""
    rng = np.random.default_rng(seed)
    rows = 4
    mag = np.abs(rng.standard_normal((rows, cols))).astype(np.float32)
    k = sparsify.keep_count(cols, 0.7)
    s, stride, offset = selection._sample_layout(cols, sample_rate, seed)
    sample_cols = offset + stride * np.arange(s)
    if kind == "zero":
        mag[:] = 0.0
    elif kind == "sparse":  # fewer than k nonzeros: no sweep is feasible
        mag[:, 10:] = 0.0
    elif kind == "ties":  # a handful of values: the k-th is tied many times
        mag = np.floor(mag * 3).astype(np.float32)
    elif kind == "nan":  # NaN counts as not >= and not <; one in the sample
        mag[:, 5] = np.nan
        mag[1, cols // 2] = np.nan
        mag[2, sample_cols[s // 2]] = np.nan
    elif kind == "inf":
        mag[:, cols - 1] = np.inf
        mag[3, sample_cols[0]] = np.inf
    elif kind == "lo_high":  # the sample far above the row: count(>= lo) < k
        mag[:, sample_cols] += np.float32(100.0)
    elif kind == "hi_low":  # the sample all 0: count(>= hi) >= k
        mag[:, sample_cols] = 0.0
    return mag, k


B4_KINDS = ["sampled", "lo_high", "hi_low", "zero", "sparse", "ties", "nan", "inf"]


def _check_b4_walk(cols, kind, sample_rate):
    """tau_k, count and the mid-gap tau of the warp walk (the sample's
    bracket, the clamp and sweeps, the mid-gap) against
    ``sampled_select_plain``, bitwise, and the rows it counts as fallen back
    against the plain chain's."""
    seed = cols + len(kind)
    mag, k = _b4_case(cols, kind, seed, sample_rate)
    tracing.enable(True)
    tracing.reset()
    try:
        want = tst.sampled_select_plain(torch.from_numpy(mag), k=k, sample_rate=sample_rate,
                                        seed=seed)
        want_fell = tracing.counters().get(tst.FALLBACK_COUNTER)
    finally:
        tracing.enable(False)
    fell = 0
    for r in range(mag.shape[0]):
        tau_k, cnt, tau, _, row_fell, _ = b4_select_walk(mag[r], k, sample_rate, seed)
        for got, w in ((tau_k, want[0][r]), (tau, want[2][r])):
            assert _bits(got) == int(w.numpy().view(np.uint32)[0]), (r, got, w)
        assert cnt == int(want[1][r])
        fell += row_fell
    assert fell == want_fell
    if kind in ("lo_high", "hi_low", "zero"):
        assert fell == mag.shape[0]


@pytest.mark.parametrize("kind", B4_KINDS)
@pytest.mark.parametrize("cols", [2049, 1025, 513, 512, 100])
def test_b4_walk_equals_refine_bracket_and_count(cols, kind):
    """The whole launch's walk equals the plain chain (``strided_sample``,
    ``sample_bracket``, ``refine_bracket`` and one count, ``mid_gap``)
    bitwise at the selector's rate 1/64 (s <= 32, one sample value a lane):
    fallbacks, the denormal bracket of the zero rows, a row where no sweep
    is feasible (its count is the fallback's count(>= 0)), ties, NaN and
    +inf in the row and in the sample."""
    _check_b4_walk(cols, kind, selection.DEFAULT_SAMPLE_RATE)


@pytest.mark.parametrize("kind", B4_KINDS)
@pytest.mark.parametrize("cols", [2049, 1025, 513, 512, 100])
def test_b4_walk_equals_the_plain_chain_at_rate_one_sixteenth(cols, kind):
    """The same at rate 1/16: s = 128 and 64 at 2049 and 1025 columns (four
    and two sample values a lane), 32 at 513 and 512 (one on every lane)."""
    _check_b4_walk(cols, kind, 1 / 16)


@pytest.mark.parametrize("cols", [2049, 1025])
def test_b4_walk_sweeps_candidates_on_spectrum_rows_and_the_row_on_zero_rows(cols):
    """On rfft magnitude rows (the main path's data) the sample fits one
    value a lane, its bisections reach their fixed point well inside 48
    sweeps, no bracket falls back, and the 11 last sweeps run over at most
    CAND_REGS candidates a lane; an all-zero row has every value in its
    bracket [0, 2**-149) and sweeps the full row, its sample done after one
    sweep and its hi fallen back."""
    rng = np.random.default_rng(cols)
    chunk = 2 * (cols - 1)
    z = np.fft.rfft(rng.standard_normal((16, chunk)) * 1e-3, axis=-1)
    w = np.full(cols, 2.0, np.float32)
    w[0] = w[-1] = 1.0
    mag = (np.abs(z).astype(np.float32) * w).astype(np.float32)
    mag[-1] = 0.0
    k = sparsify.keep_count(cols, 0.7)
    s = selection._sample_layout(cols, selection.DEFAULT_SAMPLE_RATE, 0)[0]
    assert s <= LANES
    walks = [b4_select_walk(mag[r], k, selection.DEFAULT_SAMPLE_RATE, 0)
             for r in range(mag.shape[0])]
    assert [w[3] for w in walks] == [True] * 15 + [False]
    assert [w[4] for w in walks] == [False] * 15 + [True]
    assert max(w[5] for w in walks[:15]) <= 32 and walks[15][5] == 1


def test_b4_items_cover_every_width_with_one_dispatch_entry():
    """N covers the row, wastes at most 7 items a lane, is exact at the
    main path's widths, and takes 32 values in all (the kernel's cases)."""
    ns = {b4_items(c) for c in range(1, 4097)}
    assert len(ns) == 32
    for cols in range(1, 4097):
        n = b4_items(cols)
        assert LANES * n >= cols and n - -(-cols // LANES) <= 7
    assert [b4_items(c) for c in (2049, 1025, 513)] == [65, 33, 17]


# ---------------------------------------------------------------- B1


CAND_PER_LANE = 2  # B1's candidates a lane holds after its compaction
COMPACT_AT = LANES * CAND_PER_LANE  # B1 compacts once at most this many lie in [lo, hi)


def _bits(x):
    return int(np.array([x], np.float32).view(np.uint32)[0])


def b1_walk(row, k, iters=selection.BISECT_ITERS):
    """One row as B1's warp runs it: (tau float32, count, sweeps run, the
    sweep from which the candidates served, or None)."""
    v = lane_items(row)
    m = lane_max(v)
    lo, hi = np.float32(0.0), _upper_bracket(m)
    lo_count, hi_count = lane_count(v, np.float32(0.0)), 0
    with np.errstate(invalid="ignore"):
        hi_known = bool(hi > m)  # nothing is >= hi above the maximum
    half = np.float32(0.5)
    cand, compact_at = None, None
    with np.errstate(invalid="ignore", over="ignore"):  # NaN and +inf brackets
        for it in range(iters):
            if (cand is None and hi_known and lo_count - hi_count <= COMPACT_AT and lo <= hi
                    and abs(lo) <= MAX_BRACKET and abs(hi) <= MAX_BRACKET):
                inside = (v >= lo) & (v < hi)  # (lane, item): lane order, then item
                assert int(inside.sum()) == lo_count - hi_count  # the carried counts
                slots = np.full(COMPACT_AT, np.float32(-np.inf), np.float32)
                slots[:lo_count - hi_count] = v[inside]
                cand, compact_at = slots.reshape(CAND_PER_LANE, LANES), it + 1
            mid = np.float32(half * np.float32(lo + hi))
            if cand is not None:
                c = hi_count + int((cand >= mid).sum())
                assert c == lane_count(v, mid)  # the identity the kernel relies on
            else:
                c = lane_count(v, mid)
            moved = lo if c >= k else hi
            if c >= k:
                lo, lo_count = mid, c
            else:
                hi = mid
                if cand is None:
                    hi_count, hi_known = c, True
            if _bits(mid) == _bits(moved):  # the fixed point: every later sweep repeats this
                return lo, lo_count, it + 1, compact_at
    return lo, lo_count, iters, compact_at


def _spectrum_mag(rows, cols, seed):
    """Hermitian-weighted rfft magnitudes of N(0, 1e-6) chunks, float32."""
    rng = np.random.default_rng(seed)
    z = np.fft.rfft(rng.standard_normal((rows, 2 * (cols - 1))) * 1e-3, axis=-1)
    w = np.full(cols, 2.0, np.float32)
    w[0] = w[-1] = 1.0
    return (np.abs(z).astype(np.float32) * w).astype(np.float32)


def _b1_rows(cols, kind, seed, rows=4):
    """(mag, k): ``rows`` rows of one kind, float32."""
    rng = np.random.default_rng(seed)
    k = sparsify.keep_count(cols, 0.7)
    if kind == "spectrum":
        return _spectrum_mag(rows, cols, seed), k
    mag = np.abs(rng.standard_normal((rows, cols))).astype(np.float32)
    if kind == "zero":
        mag[:] = 0.0
    elif kind == "ties":  # a handful of values: the k-th is tied many times
        mag = np.floor(mag * 3).astype(np.float32)
    elif kind == "tiny":  # one huge value: 48 sweeps do not come down to the rest
        mag *= np.float32(1e-3)
        mag[:, cols // 2] = np.float32(1e30)
    elif kind == "nan":
        mag[:, cols // 3] = np.nan
    elif kind == "inf":  # tau 0 however large the rest: the bracket is NaN
        mag *= np.float32(1e30)
        mag[:, cols - 1] = np.inf
    elif kind == "nan_inf":
        mag[:, 0] = np.inf
        mag[:, cols - 1] = np.nan
    elif kind == "flt_max":  # hi = FLT_MAX: count(>= hi) is not known to be 0
        mag[:, cols // 2] = FLT_MAX
    elif kind == "all_flt_max":  # lo + hi overflows to +inf
        mag[:] = FLT_MAX
    return mag, k


B1_KINDS = ["random", "spectrum", "zero", "ties", "tiny", "nan", "inf", "nan_inf", "flt_max",
            "all_flt_max"]


@pytest.mark.parametrize("cols,kind", [(c, kd) for c in (2049, 1025, 1, 31, 33, 257, 511, 4096)
                                       for kd in B1_KINDS if c > 1 or kd != "spectrum"])
def test_b1_walk_equals_threshold_plain(cols, kind):
    """Tau and count of B1's warp walk (maximum with NaN kept, data-driven
    compaction, stop at the fixed point) equal ``threshold_plain``
    (``selection.bisect_tau`` + one count) bitwise, the count identity
    holding at every candidate sweep."""
    mag, k = _b1_rows(cols, kind, seed=cols + len(kind))
    want_tau, want_cnt = ttt.threshold_plain(torch.from_numpy(mag), k)
    for r in range(mag.shape[0]):
        tau, cnt, _, _ = b1_walk(mag[r], k)
        assert _bits(tau) == _bits(want_tau[r, 0].numpy()), (r, tau, want_tau[r])
        assert cnt == int(want_cnt[r, 0])


@pytest.mark.parametrize("cols", [2049, 1025])
def test_b1_walk_stops_early_and_compacts_on_spectrum_rows(cols):
    """On the main path's rows B1 compacts by sweep 8 and stops by sweep 30
    of 48; an all-zero padding row stops after one sweep (lo = 0, hi =
    2**-149, mid rounds to 0) without compacting; a row holding a NaN never
    compacts."""
    mag = _spectrum_mag(32, cols, seed=cols)
    mag[-1] = 0.0
    mag[-2, 7] = np.nan
    k = sparsify.keep_count(cols, 0.7)
    walks = [b1_walk(mag[r], k) for r in range(mag.shape[0])]
    for tau, cnt, sweeps, compact_at in walks[:-2]:
        assert sweeps <= 30 and compact_at is not None and compact_at <= 8
        assert cnt >= k
    assert walks[-1][2:] == (1, None) and walks[-1][:2] == (0.0, cols)
    assert walks[-2][3] is None


def b2_bisect_columns(cols):
    """The columns the kBisect CTA holds, (THREADS, N): thread t = 32 w + l
    holds w*S + 32 j + l for j < J, then the tail column 8 S + t (no tail
    item at J = 16); -1 where the thread holds no column."""
    j_items = min(cols // THREADS, MAX_STRETCH)
    t = np.arange(THREADS)
    col = (t // LANES * LANES * j_items + LANES * np.arange(j_items)[:, None] + t % LANES).T
    if j_items < MAX_STRETCH:
        tail = WARPS * LANES * j_items + t
        col = np.concatenate([col, np.where(tail < cols, tail, -1)[:, None]], axis=1)
    return col


def kth_largest(row, k):
    """v_k: the k-th largest non-NaN value of ``row`` (NaN if there are fewer)."""
    vals = np.sort(row[~np.isnan(row)])[::-1]
    return vals[k - 1] if 0 < k <= vals.size else np.float32(np.nan)


def replay_sweeps(vk, lo, hi, k, sweeps):
    """B1's sweeps on [lo, hi) with ``v_k >= mid`` in place of
    ``count(>= mid) >= k``, the fixed-point stop included: (tau, steps)."""
    half = np.float32(0.5)
    with np.errstate(invalid="ignore", over="ignore"):
        for step in range(sweeps):
            mid = np.float32(half * np.float32(lo + hi))
            feasible = k <= 0 or bool(vk >= mid)
            moved = lo if feasible else hi
            lo, hi = (mid, hi) if feasible else (lo, mid)
            if _bits(mid) == _bits(moved):
                return lo, step + 1
    return lo, sweeps


CTA_CAND = 2 * THREADS  # values in [lo, hi) the kBisect CTA sweeps alone: two a thread
RANK_AT = 32  # values in [lo, hi) warp 0 ranks: one a lane
UNKNOWN = -(1 << 30)  # count(>= hi) not known yet: lo_count - hi_count exceeds every cap


def b2_bisect_walk(row, k, iters=selection.BISECT_ITERS, warp_order=None):
    """One row as B2's kBisect CTA selects it: (tau float32, sweeps over the
    row, sweeps over the candidates, values ranked or None, replay steps).
    ``warp_order``: the order in which the warps' shared atomics hand out
    candidate slots."""
    col = b2_bisect_columns(row.size)
    v = np.where(col >= 0, row[np.maximum(col, 0)], np.float32(-np.inf)).astype(np.float32)
    vw = v.reshape(WARPS, LANES, -1)  # (warp, lane, item)

    def count(t):  # each warp's warp_count_ge, summed as every thread sums them
        return sum(lane_count(vw[w], t) for w in range(WARPS))

    # the maximum: the largest bit pattern as a signed integer (a NaN of the
    # card, 0x7fffffff, above +inf); B1's fmaxf with a NaN kept when no
    # value has its sign bit clear
    imax = int(v.view(np.int32).max())
    if imax >= 0:
        m = np.array([imax], np.int32).view(np.float32)[0]
    else:
        m = lane_max(vw[0])
        for w in range(1, WARPS):  # the first warp's NaN, else the maximum
            x = lane_max(vw[w])
            m = m if np.isnan(m) else x if np.isnan(x) else np.float32(np.fmax(m, x))
    lo, hi = np.float32(0.0), _upper_bracket(m)
    lo_count = count(np.float32(0.0))
    with np.errstate(invalid="ignore"):
        hi_count = 0 if hi > m else UNKNOWN  # count(>= hi) known: nothing above the maximum
    half = np.float32(0.5)
    it = cta_sweeps = 0

    def sweep(c):  # B1's update from count(>= mid); True at the fixed point
        nonlocal lo, hi, lo_count, hi_count, it
        it += 1
        moved = lo if c >= k else hi
        if c >= k:
            lo, lo_count = mid, c
        else:
            hi, hi_count = mid, c
        return _bits(mid) == _bits(moved)

    with np.errstate(invalid="ignore", over="ignore"):
        while it < iters:
            if (lo_count - hi_count <= CTA_CAND and lo <= hi and abs(lo) <= MAX_BRACKET
                    and abs(hi) <= MAX_BRACKET):
                break
            mid = np.float32(half * np.float32(lo + hi))
            cta_sweeps += 1
            if sweep(count(mid)):
                return lo, cta_sweeps, 0, None, 0
    if it == iters:
        return lo, cta_sweeps, 0, None, 0
    # the CTA's candidates in any order (each thread's atomic takes its
    # slots): the warps in ``warp_order``; thread t holds slots t and t + 256
    inside = (vw >= lo) & (vw < hi)
    n = lo_count - hi_count
    assert int(inside.sum()) == n <= CTA_CAND  # the carried counts
    order = range(WARPS) if warp_order is None else warp_order
    slots = np.full(CTA_CAND, np.float32(-np.inf), np.float32)
    slots[:n] = np.concatenate([vw[w][inside[w]] for w in order])
    cw = slots.reshape(2, WARPS, LANES).transpose(1, 2, 0)  # (warp, lane, item)
    base = hi_count  # count(>= hi) at the compaction
    cand_sweeps = 0
    with np.errstate(invalid="ignore", over="ignore"):
        while it < iters and lo_count - hi_count > RANK_AT:
            mid = np.float32(half * np.float32(lo + hi))
            c = base + sum(lane_count(cw[w], mid) for w in range(WARPS))
            assert c == count(mid)  # the identity the candidate sweeps rely on
            cand_sweeps += 1
            if sweep(c):
                return lo, cta_sweeps, cand_sweeps, None, 0
    if it == iters:
        return lo, cta_sweeps, cand_sweeps, None, 0
    # the values left in [lo, hi) to warp 0, one a lane in any order, then
    # v_k: the largest of them with at least r = k - count(>= hi) at or
    # above it
    n = lo_count - hi_count
    inside = (slots >= lo) & (slots < hi)
    assert int(inside.sum()) == n <= RANK_AT
    x = np.full(RANK_AT, np.float32(-np.inf), np.float32)
    x[:n] = slots[inside][::-1]
    r = k - hi_count
    ge = (x[None, :] >= x[:, None]).sum(axis=1)
    sel = (np.arange(RANK_AT) < n) & (ge >= r)
    if r <= 0:
        vk = np.float32(np.inf)
    elif sel.any():
        key = (x[sel] + np.float32(0.0)).view(np.uint32).max()  # -0 -> +0, then bits
        vk = np.array([key], np.uint32).view(np.float32)[0]
    else:
        vk = np.float32(-np.inf)
    want = kth_largest(row, k)
    assert vk == want or (np.isnan(want) or want < lo) and vk == -np.inf
    tau, steps = replay_sweeps(vk, lo, hi, k, iters - it)
    return tau, cta_sweeps, cand_sweeps, n, steps


B2_EDGE_KINDS = ["few_finite", "negative", "all_tied", "inf_k_minus_1", "neg_inf", "few_flt_max"]
# rows of +0 and -0: which zero a maximum returns depends on the order it
# meets them (the plain version's amax, B1's and B2's fmaxf alike), and
# tau's sign follows it; B2's magnitudes, sqrt(re^2 + im^2) * w, are never
# -0, so only the replay lemma takes these rows
LEMMA_KINDS = B1_KINDS + B2_EDGE_KINDS + ["signed_zero"]


def _edge_rows(cols, kind, seed, rows=4):
    """(mag, k): ``rows`` rows of B1_KINDS or of the edge kinds of B2's
    selection, float32."""
    if kind in B1_KINDS:
        return _b1_rows(cols, kind, seed, rows)
    rng = np.random.default_rng(seed)
    k = sparsify.keep_count(cols, 0.7)
    mag = np.abs(rng.standard_normal((rows, cols))).astype(np.float32)
    if kind == "few_finite":  # k - 1 values, the rest NaN: no mid is feasible
        mag[:, k - 1:] = np.nan
        mag[1] = rng.permutation(mag[1])
    elif kind == "signed_zero":
        mag[:] = np.float32(0.0)
        mag[:, ::3] = np.float32(-0.0)
    elif kind == "negative":  # the bracket [0, hi] is upside down
        mag = -mag
    elif kind == "all_tied":  # every value ties with v_k
        mag[:] = np.float32(0.37)
    elif kind == "inf_k_minus_1":
        mag[:, rng.permutation(cols)[:k - 1]] = np.inf
    elif kind == "neg_inf":
        mag[:, ::7] = -np.inf
    elif kind == "few_flt_max":  # 10 values >= 0, one FLT_MAX: count(>= hi) is not 0
        mag[:, 10:] = -np.inf
        mag[:, 3] = FLT_MAX
    return mag, k


B2_BISECT_CASES = [(c, kd) for c in (2049, 1025, 513, 300, 100, 4096)
                   for kd in B1_KINDS + B2_EDGE_KINDS]


@pytest.mark.parametrize("cols,kind", B2_BISECT_CASES)
def test_b2_bisect_walk_equals_threshold_plain(cols, kind):
    """B2 with tau=None: the CTA walk (stretch and tail items, the maximum
    by bit pattern, CTA-wide counts, the compaction in any warp order, the
    sweeps over the candidates, v_k by rank, the replay) gives
    ``threshold_plain``'s tau bitwise, so the kernel's tau is B1's."""
    mag, k = _edge_rows(cols, kind, seed=cols + len(kind))
    want_tau, _ = ttt.threshold_plain(torch.from_numpy(mag), k)
    rng = np.random.default_rng(cols)
    for r in range(mag.shape[0]):
        tau = b2_bisect_walk(mag[r], k, warp_order=rng.permutation(WARPS))[0]
        assert _bits(tau) == _bits(want_tau[r, 0].numpy()), (r, tau, want_tau[r])


@pytest.mark.parametrize("cols", [2049, 1025, 513, 300, 100, 4096, 1])
def test_b2_bisect_columns_cover_the_row_once(cols):
    """Every column is held by exactly one item; the tail (8 S to the
    row's end) sits one column a thread."""
    col = b2_bisect_columns(cols)
    np.testing.assert_array_equal(np.sort(col[col >= 0]), np.arange(cols))
    assert col.shape[1] == min(cols // THREADS, MAX_STRETCH) + (cols < THREADS * MAX_STRETCH)


@pytest.mark.parametrize("cols,kind", [(c, kd) for c in (2049, 1025, 300, 4096)
                                       for kd in LEMMA_KINDS])
def test_bisect_replay_lemma(cols, kind):
    """The replay lemma: count(>= mid) >= k exactly when v_k >= mid, for
    every mid NaN and infinities included, so B1's whole bisection from
    [0, upper_bracket(max)] replayed with v_k (by a sort) in place of the
    counts gives ``selection.bisect_tau`` bitwise."""
    mag, k = _edge_rows(cols, kind, seed=cols + len(kind))
    t = torch.from_numpy(mag)
    want = selection.bisect_tau(t, k).numpy()
    hi = selection.upper_bracket(torch.amax(t, dim=-1)).numpy()
    for r in range(mag.shape[0]):
        vk = kth_largest(mag[r], k)
        tau, _ = replay_sweeps(vk, np.float32(0.0), hi[r], k, selection.BISECT_ITERS)
        assert _bits(tau) == _bits(want[r]), (r, tau, want[r])
        with np.errstate(invalid="ignore", over="ignore"):
            mids = (np.float32(np.nan), np.float32(np.inf), np.float32(-np.inf), mag[r].min(), vk,
                    np.nextafter(vk, np.float32(np.inf)))
        for mid in mids:
            with np.errstate(invalid="ignore"):
                assert (int((mag[r] >= mid).sum()) >= k) == bool(vk >= mid)


@pytest.mark.parametrize("cols", [2049, 1025])
def test_b2_bisect_walk_compacts_early_and_replays_on_spectrum_rows(cols):
    """On the main path's rows the CTA sweeps the row at most 4 times
    before at most 512 values are left in the bracket, sweeps those at most
    5 times before at most 32 are left, and warp 0 ranks them and replays at
    most 24 sweeps; an all-zero padding row stops after one sweep and a row
    holding a NaN after at most two (its bracket is NaN), neither
    compacting."""
    mag = _spectrum_mag(32, cols, seed=cols)
    mag[-1] = 0.0
    mag[-2, 7] = np.nan
    k = sparsify.keep_count(cols, 0.7)
    walks = [b2_bisect_walk(mag[r], k) for r in range(mag.shape[0])]
    for _, row_sweeps, cand_sweeps, n, steps in walks[:-2]:
        assert row_sweeps <= 4 and cand_sweeps <= 5 and n <= RANK_AT and steps <= 24
    assert walks[-1][1:4] == (1, 0, None)
    assert walks[-2][1] <= 2 and walks[-2][3] is None


# ---------------------------------------------------------------- B6a


def _pack_rows(cols, kind, seed, rows=3):
    """(x, tau, k): signed rows and a per-row tau giving ``kind`` counts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    k = tpk.K_TILE * max(1, -(-sparsify.keep_count(cols, 0.7) // tpk.K_TILE))
    mag = np.sort(np.abs(x), axis=1)[:, ::-1]
    if kind == "none":  # nothing kept
        tau = np.full(rows, np.inf, np.float32)
    elif kind == "exact":  # exactly min(k, cols) kept
        tau = mag[:, min(k, cols) - 1].copy()
    elif kind == "over":  # tau 0: every column kept, cut at k
        tau = np.zeros(rows, np.float32)
        x[0] = 0.0  # |0| >= 0: an all-zero row keeps every column too
    else:  # "random": about a third kept
        tau = mag[:, cols // 3].copy()
    return x, tau.astype(np.float32), k


@pytest.mark.parametrize("kind", ["none", "exact", "over", "random"])
@pytest.mark.parametrize("cols", [2049, 1025, 513, 100, 1, 4096, 5000])
def test_b6a_walk_equals_pack_plain_slots(cols, kind):
    """B6a's column map and slot scan (B2's, on keep = |x| >= tau) give
    ``pack_plain``'s slots bitwise: values and columns in index order,
    (0.0, 0) past the count, a count beyond k cut at k; every phase-2 warp
    store on distinct banks."""
    x, tau, k = _pack_rows(cols, kind, seed=cols + len(kind))
    p_vals, p_idx = tpk.pack_plain(torch.from_numpy(x), torch.from_numpy(tau)[:, None], k=k)
    for r in range(x.shape[0]):
        keep = np.abs(x[r]) >= tau[r]
        idx, filled, writes = compact_walk(keep, k)
        vals = np.where(np.arange(k) < filled, x[r][idx], np.float32(0.0))
        np.testing.assert_array_equal(idx, p_idx[r].numpy())
        assert vals.astype(np.float32).view(np.uint32).tolist() == \
            p_vals[r].numpy().view(np.uint32).tolist()
        assert filled == min(int(keep.sum()), k)
        if kind == "none":
            assert filled == 0
        elif kind == "exact":
            assert filled == min(k, cols)
        elif kind == "over":
            assert filled == min(k, cols) and int(keep.sum()) == cols
        for slots in writes:
            assert len(set(slots % 32)) == len(slots)

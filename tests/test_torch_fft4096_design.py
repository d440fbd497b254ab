"""The index arithmetic of the FFT cores of kernels B7 and B3
(``src/repro_torch/kernels/csrc/fft4096.cuh``), transcribed into numpy and
walked on the CPU, where no CUDA kernel runs.

The complex core (B7): 4096 = 16 x 16 x 16, one CTA of 256 threads per row,
16 complex points per thread in registers, three radix-16 passes and two
exchanges through shared memory (re and im as two 4096-float planes):

* pass A: thread t = n0 + 16*n1 takes x[t + 256*m], m = 0..15; a 16-point
  DFT gives k0; times W^(t*k0); stored at ``addr(n0, n1, k0)``;
* pass B: thread t = n0 + 16*k0 takes n1 = 0..15 from ``addr(n0, n1, k0)``;
  a 16-point DFT gives k1; times W^(16*n0*k1); stored in place at
  ``addr(n0, k1, k0)``;
* pass C: thread t = k0 + 16*k1 takes n0 = 0..15 from ``addr(n0, k1, k0)``;
  a 16-point DFT gives k2; X[t + 256*k2] goes straight to device memory.

The real core (B3): the real 4096-point inverse of a Hermitian half
spectrum X[0..2048] as one 2048-point complex inverse, 128 threads per row:
pass A takes Z[n] = (X[n] + X*[2048-n]) + i (X[n] - X*[2048-n]) w^n for
n = t + 128*m (w = exp(+2 pi i/4096); only the real parts of X[0] and
X[2048] count), a 16-point DFT gives q0, times w^(2*t*q0), stored at
``addr2(n0, n1, q0)`` (t = n0 + 16*n1, n1 < 8); pass B: thread u = n0 + 16*c
runs two 8-point DFTs (q0 = 2c and 2c + 1) over n1, times w^(32*n0*q1), in
place at ``addr2(n0, q1, q0)``; pass C: thread v = q0 + 16*q1 takes
n0 = 0..15, a 16-point DFT gives q2, and z = x[2p] + i x[2p+1] at
p = v + 128*q2 goes to device memory as one float2.

``addr``/``addr2`` swizzle the bank (address mod 32) with an XOR so that
every warp instruction of every pass touches 32 distinct banks.  The
checks: the address maps are bijections; the forms the passes compute
equal them; every shared access is free of bank conflicts and every device
access and twiddle read is one contiguous span; the walks in float64 are
the transforms within 1e-12 * max; the walks in float32, with the port's
twiddle table, agree with the reference's ``fft4096_pallas`` (interpret
mode) within 2e-6 * max per row, the tolerance the kernels are held to on
the card.  ``csrc/fft4096.cuh`` names this file: the two change together.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft4step as jfft4
from repro_torch.kernels import fft4step as tfft4

N, R = 4096, 16  # points, radix
HALF = N // 2
T, T2 = 256, 128  # threads per row: complex core, real core
SLOTS = np.arange(R)
TW_B, TW_HALF = N, N + 256  # table offsets: pass B's entries, the real core's w^n


def addr(a, b, c):
    """Exchange word of the complex core (``word`` in the .cuh's note)."""
    return ((b >> 1) + 8 * c) * 32 + ((a ^ c) & 15) + 16 * ((b ^ c) & 1)


def addr2(a, b, c):
    """Exchange word of the real core (``word2`` in the .cuh's note), b < 8."""
    return ((b >> 1) + 4 * c) * 32 + ((a ^ c) & 15) + 16 * ((b ^ (c >> 1)) & 1)


def pass_maps(core):
    """Per pass, (read, write) index arrays of shape (threads, slots): where
    thread t's slot j comes from and goes to.  Pass A reads its input and
    pass C writes device memory (the real core: float2 pairs, as the word of
    the first float); the rest is the shared exchange buffer."""
    t = np.arange(T if core == "complex" else T2)[:, None]
    lo, hi, j = t & 15, t >> 4, SLOTS[None, :]
    if core == "complex":
        return {"A": (t + T * j, addr(lo, hi, j)),  # t = n0 + 16 n1; j: m -> k0
                "B": (addr(lo, j, hi), addr(lo, j, hi)),  # t = n0 + 16 k0; j: n1 -> k1
                "C": (addr(j, hi, lo), t + T * j)}  # t = k0 + 16 k1; j: n0 -> k2
    group = addr2(lo, j & 7, 2 * hi + (j >> 3))  # u = n0 + 16 c; j: n1 + 8 (q0 & 1)
    return {"A": (t + T2 * j, addr2(lo, hi, j)),  # t = n0 + 16 n1; j: m -> q0
            "B": (group, group),
            "C": (addr2(j, hi, lo), 2 * (t + T2 * j))}  # v = q0 + 16 q1; j: n0 -> q2


def twiddle_index(core):
    """Per pass with a twiddle, (table entry, exponent of w) for each
    (thread, output slot); the real core's "pre" is pass A's input w^n."""
    t = np.arange(T if core == "complex" else T2)[:, None]
    lo, j = t & 15, SLOTS[None, :]
    if core == "complex":
        return {"A": (t + T * j, t * j), "B": (TW_B + lo + R * j, R * lo * j)}
    n = t + T2 * j
    return {"pre": (TW_HALF + n, n), "A": (2 * t + T * j, 2 * t * j),
            "B": (TW_B + lo + 2 * R * (j & 7), 2 * R * lo * (j & 7))}


def exact_table():
    """The table's exponents in float64: pass A and B of the complex core,
    then w^n for n < 2048."""
    t, r = np.arange(T), np.arange(R)
    e = np.concatenate([(r[:, None] * t[None, :]).reshape(-1),
                        (R * r[:, None] * r[None, :]).reshape(-1), np.arange(HALF)])
    ang = 2.0 * np.pi * e / N
    return np.stack([np.cos(ang), np.sin(ang)], -1)


def dft4(x, p, s, dt):
    """4-point DFT in place on positions p of the list of (re, im) pairs."""
    (ar, ai), (br, bi), (cr, ci), (dr, di) = (x[i] for i in p)
    t0r, t0i, t1r, t1i = ar + cr, ai + ci, ar - cr, ai - ci
    t2r, t2i, t3r, t3i = br + dr, bi + di, br - dr, bi - di
    rr, ri = dt(-s) * t3i, dt(s) * t3r  # t3 * (s*i)
    x[p[0]], x[p[2]] = [t0r + t2r, t0i + t2i], [t0r - t2r, t0i - t2i]
    x[p[1]], x[p[3]] = [t1r + rr, t1i + ri], [t1r - rr, t1i - ri]


def w16(m, s, dt):
    ang = 2.0 * np.pi * m / R
    return dt(np.cos(ang)), dt(s * np.sin(ang))


def cmul(v, w):
    return [v[0] * w[0] - v[1] * w[1], v[0] * w[1] + v[1] * w[0]]


def dft16(x, s, dt):
    """The core's in-register 16-point DFT (radix 4 x 4, constant W16
    factors) on a list of 16 (re, im) pairs."""
    for j in range(4):
        dft4(x, [j, j + 4, j + 8, j + 12], s, dt)
        for k1 in range(1, 4):
            if j * k1:
                x[j + 4 * k1] = cmul(x[j + 4 * k1], w16(j * k1, s, dt))
    for k1 in range(4):
        dft4(x, [4 * k1, 4 * k1 + 1, 4 * k1 + 2, 4 * k1 + 3], s, dt)
    return [x[4 * (k % 4) + k // 4] for k in range(R)]  # X[k1 + 4 k2] sits at 4 k1 + k2


def dft8(x, s, dt):
    """The real core's 8-point DFT: DFT4 of the even and of the odd points,
    the odd ones times W16^(2k), one radix-2 step."""
    dft4(x, [0, 2, 4, 6], s, dt)
    dft4(x, [1, 3, 5, 7], s, dt)
    odd = [x[1]] + [cmul(x[2 * k + 1], w16(2 * k, s, dt)) for k in range(1, 4)]
    even = [x[2 * k] for k in range(4)]
    return ([[e[0] + o[0], e[1] + o[1]] for e, o in zip(even, odd)]
            + [[e[0] - o[0], e[1] - o[1]] for e, o in zip(even, odd)])


def slots(re, im, dt):
    return [[re[..., i].astype(dt), im[..., i].astype(dt)] for i in range(R)]


def unslots(x):
    return np.stack([v[0] for v in x], -1), np.stack([v[1] for v in x], -1)


def walk(x_re, x_im, inverse, dt, table):
    """The complex core on (rows, 4096) planes; ``table`` is the twiddle
    table as (entries, 2) re/im of exp(+2 pi i e / 4096)."""
    maps, tw = pass_maps("complex"), twiddle_index("complex")
    s = 1.0 if inverse else -1.0
    tre, tim = table[:, 0].astype(dt), table[:, 1].astype(dt) * dt(s)
    smem_re = np.zeros((x_re.shape[0], N), dt)
    smem_im = np.zeros_like(smem_re)
    re, im = x_re.astype(dt)[:, maps["A"][0]], x_im.astype(dt)[:, maps["A"][0]]
    for name in "ABC":
        if name != "A":
            re, im = smem_re[:, maps[name][0]], smem_im[:, maps[name][0]]
        re, im = unslots(dft16(slots(re, im, dt), s, dt))
        if name in tw:
            re, im = cmul([re, im], [tre[tw[name][0]], tim[tw[name][0]]])
        if name != "C":
            smem_re[:, maps[name][1]], smem_im[:, maps[name][1]] = re, im
    out_re, out_im = np.empty_like(smem_re), np.empty_like(smem_im)
    scale = dt(1.0 / N if inverse else 1.0)
    out_re[:, maps["C"][1]], out_im[:, maps["C"][1]] = re * scale, im * scale
    return out_re, out_im


def walk_real(x_re, x_im, dt, table):
    """The real core: (rows, 2049) half spectrum -> (rows, 4096) real signal."""
    maps, tw = pass_maps("real"), twiddle_index("real")
    tre, tim = table[:, 0].astype(dt), table[:, 1].astype(dt)
    x_re, x_im = x_re.astype(dt), x_im.astype(dt).copy()
    x_im[:, [0, HALF]] = 0.0  # only the real parts of DC and Nyquist count
    n = maps["A"][0]
    a = [x_re[:, n], x_im[:, n]]
    b = [x_re[:, HALF - n], -x_im[:, HALF - n]]
    d = cmul([a[0] - b[0], a[1] - b[1]], [tre[tw["pre"][0]], tim[tw["pre"][0]]])
    re, im = a[0] + b[0] - d[1], a[1] + b[1] + d[0]
    smem_re = np.zeros((x_re.shape[0], HALF), dt)
    smem_im = np.zeros_like(smem_re)
    for name in "ABC":
        if name != "A":
            re, im = smem_re[:, maps[name][0]], smem_im[:, maps[name][0]]
        x = slots(re, im, dt)
        x = dft8(x[:8], 1.0, dt) + dft8(x[8:], 1.0, dt) if name == "B" else dft16(x, 1.0, dt)
        re, im = unslots(x)
        if name in tw:
            re, im = cmul([re, im], [tre[tw[name][0]], tim[tw[name][0]]])
        if name != "C":
            smem_re[:, maps[name][1]], smem_im[:, maps[name][1]] = re, im
    out = np.empty((x_re.shape[0], N), dt)
    scale = dt(1.0 / N)
    out[:, maps["C"][1]], out[:, maps["C"][1] + 1] = re * scale, im * scale
    return out


def half_spectrum(rng, rows):
    x = rng.standard_normal((rows, HALF + 1)) + 1j * rng.standard_normal((rows, HALF + 1))
    x[-1] = 0.0
    x[-1, 3] = 1.0  # a single bin: a cosine
    return x


@pytest.mark.parametrize("core", ["complex", "real"])
def test_exchange_address_is_a_bijection_on_every_pass(core):
    maps = pass_maps(core)
    size = N if core == "complex" else HALF
    for name, (read, write) in maps.items():
        for m, shared in ((read, name != "A"), (write, name != "C")):
            if shared:
                assert sorted(m.reshape(-1).tolist()) == list(range(size)), name
    # what pass A stores from slot k0 (q0) pass B loads into slot n1, and
    # what pass B stores pass C loads; pass B works in place per thread
    a, b, c = np.meshgrid(SLOTS, SLOTS, SLOTS, indexing="ij")
    if core == "complex":
        assert (maps["A"][1][a + R * b, c] == maps["B"][0][a + R * c, b]).all()
        assert (maps["B"][1][a + R * c, b] == maps["C"][0][c + R * b, a]).all()
    else:
        a, b, c = a[:, :8], b[:, :8], c[:, :8]
        slot_b = b + 8 * (c & 1)
        assert (maps["A"][1][a + R * b, c] == maps["B"][0][a + R * (c >> 1), slot_b]).all()
        assert (maps["B"][1][a + R * (c >> 1), slot_b] == maps["C"][0][c + R * b, a]).all()
    assert (maps["B"][0] == maps["B"][1]).all()


@pytest.mark.parametrize("core", ["complex", "real"])
def test_per_pass_address_forms_equal_the_address_map(core):
    """The forms the passes compute in the .cuh, each a constant offset or
    one XOR per slot."""
    maps = pass_maps(core)
    t = np.arange(T if core == "complex" else T2)[:, None]
    lo, hi, j = t & 15, t >> 4, SLOTS[None, :]
    if core == "complex":  # the pass A word, base_b, base_c in fft4096_row
        assert ((t ^ (j | (j & 1) << 4)) + 256 * j == maps["A"][1]).all()
        base_b0 = 256 * hi + (((lo ^ hi) & 15) | (hi & 1) << 4)
        base_b = np.where(j & 1, base_b0 ^ 16, base_b0)
        assert (base_b + 32 * (j >> 1) == maps["B"][0]).all()
        base_c = (32 * (hi >> 1) + 256 * lo + 16 * ((hi ^ lo) & 1)) | lo
        assert (base_c ^ j == maps["C"][0]).all()
    else:  # the pass A word, base_e0/base_e1 (^ 16), base_c in fft4096_real_inverse_row
        assert ((t ^ (j | ((j >> 1) & 1) << 4)) + 128 * j == maps["A"][1]).all()
        c = 2 * hi + (j >> 3)
        base = 128 * c + ((lo ^ c) & 15) + 16 * (hi & 1)
        assert ((base ^ 16 * (j & 1)) + 32 * ((j & 7) >> 1) == maps["B"][0]).all()
        base_c = (32 * ((hi >> 1) + 4 * lo) + 16 * ((hi ^ (lo >> 1)) & 1)) | lo
        assert (base_c ^ j == maps["C"][0]).all()


@pytest.mark.parametrize("core", ["complex", "real"])
@pytest.mark.parametrize("name", ["A", "B", "C"])
def test_every_warp_access_is_conflict_free_and_coalesced(core, name):
    read, write = pass_maps(core)[name]
    warps = read.shape[0] // 32
    for m, shared in ((read, name != "A"), (write, name != "C")):
        for w in range(warps):
            for j in SLOTS:
                words = m[32 * w: 32 * (w + 1), j]
                if shared:  # 4-byte words: bank = word mod 32
                    assert len(set((words % 32).tolist())) == 32, (name, w, j)
                else:  # device or half-spectrum words: one contiguous span per warp
                    step = 2 if core == "real" and name == "C" else 1
                    assert (words == words[0] + step * np.arange(32)).all()
    if core == "real" and name == "A":  # the mirrored reads X[2048 - n]: 32 distinct banks
        for w in range(warps):
            for j in SLOTS:
                assert len(set(((HALF - read[32 * w: 32 * (w + 1), j]) % 32).tolist())) == 32
    tw = twiddle_index(core)
    for key in [k for k in tw if k == name or (name == "A" and k == "pre")]:
        for w in range(warps):
            for j in SLOTS:
                e = np.unique(tw[key][0][32 * w: 32 * (w + 1), j])
                step = 2 if (core, key) == ("real", "A") else 1
                assert (e == e[0] + step * np.arange(len(e))).all(), (key, w, j)


def test_twiddle_table_holds_the_exponents_the_passes_use():
    table = tfft4.twiddles(torch.device("cpu")).numpy()
    assert table.shape == (N + 256 + HALF, 2) and table.dtype == np.float32
    np.testing.assert_array_equal(table, exact_table().astype(np.float32))
    for core in ("complex", "real"):
        for name, (entry, expo) in twiddle_index(core).items():
            ang = 2.0 * np.pi * (expo % N) / N
            np.testing.assert_array_equal(table[entry, 0], np.cos(ang).astype(np.float32))
            np.testing.assert_array_equal(table[entry, 1], np.sin(ang).astype(np.float32))


@pytest.mark.parametrize("inverse", [False, True])
def test_float64_walk_is_the_dft(inverse):
    rng = np.random.default_rng(11 + inverse)
    x = rng.standard_normal((3, N)) + 1j * rng.standard_normal((3, N))
    x[2] = 0.0
    x[2, 0] = 1.0  # a unit impulse: every bin 1 (inverse: 1/4096)
    y_re, y_im = walk(x.real, x.imag, inverse, np.float64, exact_table())
    want = np.fft.ifft(x, axis=-1) if inverse else np.fft.fft(x, axis=-1)
    scale = np.abs(want).max(-1, keepdims=True)
    assert np.all(np.abs(y_re + 1j * y_im - want) <= 1e-12 * scale)


def test_float64_real_walk_is_the_real_inverse():
    x = half_spectrum(np.random.default_rng(5), 3)
    got = walk_real(x.real, x.imag, np.float64, exact_table())
    spec = x.copy()
    spec[:, [0, HALF]] = spec[:, [0, HALF]].real  # the Hermitian reading of DC and Nyquist
    want = np.fft.irfft(spec, n=N, axis=-1)
    assert np.all(np.abs(got - want).max(-1) <= 1e-12 * np.abs(want).max(-1))


@pytest.mark.parametrize("inverse", [False, True])
def test_float32_walk_matches_pallas_within_tolerance(inverse):
    rng = np.random.default_rng(7 + inverse)
    x_re = rng.standard_normal((3, N)).astype(np.float32)
    x_im = (rng.standard_normal((3, N)) * 1e-2).astype(np.float32)
    table = tfft4.twiddles(torch.device("cpu")).numpy()
    y_re, y_im = walk(x_re, x_im, inverse, np.float32, table)
    assert y_re.dtype == np.float32
    j_re, j_im = (np.asarray(v) for v in jfft4.fft4096_pallas(
        jnp.asarray(x_re), jnp.asarray(x_im), inverse=inverse, interpret=True))
    scale = np.maximum(np.abs(j_re).max(-1), np.abs(j_im).max(-1))
    for got, want in ((y_re, j_re), (y_im, j_im)):
        assert np.all(np.abs(got - want).max(-1) <= 2e-6 * scale)


def test_float32_real_walk_matches_pallas_within_tolerance():
    """Against the reference's inverse transform of the Hermitian spectrum
    (bin i and the conjugate mirror at 4096 - i, as its fused decompress
    builds it), real part."""
    x = half_spectrum(np.random.default_rng(9), 3).astype(np.complex64)
    table = tfft4.twiddles(torch.device("cpu")).numpy()
    got = walk_real(x.real, x.imag, np.float32, table)
    assert got.dtype == np.float32
    full = np.zeros((3, N), np.complex64)
    full[:, : HALF + 1] = x
    full[:, HALF + 1:] = np.conj(x[:, 1:HALF][:, ::-1])
    j_re, _ = jfft4.fft4096_pallas(jnp.asarray(full.real.copy()), jnp.asarray(full.imag.copy()),
                                   inverse=True, interpret=True)
    want = np.asarray(j_re)
    assert np.all(np.abs(got - want).max(-1) <= 2e-6 * np.abs(want).max(-1))

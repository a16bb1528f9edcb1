"""K6's algorithm (``kernels/csrc/ts_mask.cu``, ``ts_encode_kernel``)
emulated in numpy, where there is no card, and held against the
reference's ``repro.core.ts.ts_encode``; and the port's ``ops.ts_encode``
on the CPU (``ts_encode_ref``) against the same reference on the same
grid.

The emulation follows the kernel step by step: tiles that write x into
``below`` and append their candidates' 64-bit keys (|x|'s bits, NaN made
canonical, over the complement of the flat index and x's sign bit) in an
order the atomics decide (here a shuffle of the tiles); the radix select
of the C-th largest key over the bits that differ between candidates, 8
bits a pass, until the keys in play (the top C and those tied with the
C-th down to the digits resolved so far) fit one chunk of the sort or
are the top C; those keys sorted a chunk at a time (each warp's 32, then
runs merged pairwise by rank) and placed by rank across chunks; and x,
decoded from its key, written into the carrier, and 0 into ``below`` at
each of the top C. It runs at the kernel's tile and chunk sizes and at
small ones, so that a small input spans many tiles and chunks.

Tolerance: exact equality everywhere. Against the reference the values
are compared as numbers (the reference multiplies a kept entry by 0, so a
negative one is -0 there and +0 in the port's ``below``); against the
port's plain version, bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ts_mask as tsm

JTS = importlib.import_module("repro.core.ts")

NAN_KEY = 0x7FC00000
TILE, CHUNK = 4096, 1024  # the kernel's kTile and kChunk
# small tiles and chunks: many of each on a small input
SMALL = [(64, 8), (64, 64)]


def _keys(vals: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """|x|'s bits (NaN canonical) over (~index << 1 | x's sign bit)."""
    a = np.abs(vals)
    mag = a.view(np.uint32).astype(np.uint64)
    mag[np.isnan(a)] = NAN_KEY
    low = (~idx.astype(np.uint32) << np.uint32(1)) | (
        vals.view(np.uint32) >> np.uint32(31))
    return (mag << np.uint64(32)) | low.astype(np.uint64)


def _index(key: int) -> int:
    return ~((key & 0xFFFFFFFF) >> 1) & 0x7FFFFFFF


def _value(key: int) -> np.float32:
    bits = (key >> 32) | ((key & 1) << 31)
    return np.array([bits], np.uint32).view(np.float32)[0]


def emulate(x: np.ndarray, tau: float, cap: int, tile=TILE, chunk=CHUNK,
            seed=0):
    """K6 on x (T, D) f32 → (below, values, indices, count)."""
    flat = x.reshape(-1).astype(np.float32)
    n, tau = flat.size, np.float32(tau)
    below = flat.copy()  # each tile writes x
    blocks, count, k_or, k_not_and = [], 0, 0, 0
    for first in range(0, n, tile):  # 1. each block's tile
        seg = flat[first:first + tile]
        a = np.abs(seg)
        nan = np.isnan(a)
        cand = nan | (a >= tau)
        keys = _keys(seg[cand], first + np.nonzero(cand)[0])
        count += int((cand & ~nan).sum())
        for key in keys.tolist():
            k_or |= key
            k_not_and |= ~key & (2**64 - 1)
        blocks.append(keys)
    # the blocks append in whatever order their atomics land
    order = np.random.default_rng(seed).permutation(len(blocks))
    cand = np.concatenate([blocks[b] for b in order])
    # 2. the last block: S, the keys in play (those with key & mask >=
    # prefix), narrowed by radix select until it fits a chunk or is the
    # top k
    k = min(cap, cand.size)
    mask, prefix = 0, 0 if k else 1
    n_s, need, rest = (cand.size if k else 0), k, k_or & k_not_and
    while n_s > max(k, chunk) and rest:  # rest: the bits that differ
        hi = rest.bit_length()
        lo = max(hi - 8, 0)
        digit = ((1 << (hi - lo)) - 1) << lo
        live = cand[(cand & np.uint64(mask)) == np.uint64(prefix)]
        hist = np.bincount(((live & np.uint64(digit)) >> np.uint64(lo))
                           .astype(np.int64), minlength=256)
        upto = np.cumsum(hist[::-1])[::-1]  # the bin and those above
        b = int(np.nonzero((upto - hist < need) & (need <= upto))[0][0])
        prefix |= b << lo
        mask |= digit
        need -= int(upto[b] - hist[b])
        n_s = k - need + int(hist[b])
        rest &= (1 << lo) - 1
    in_s = cand[(cand & np.uint64(mask)) >= np.uint64(prefix)]
    assert in_s.size == n_s and n_s >= k
    # 3. S sorted a chunk at a time; its top k at their ranks in the
    # carrier, and 0 in below
    chunks = [_sort_chunk(in_s[c:c + chunk]) for c in range(0, n_s, chunk)]
    values = np.zeros(cap, np.float32)
    indices = np.full(cap, -1, np.int64)
    for c, own in enumerate(chunks):
        for p, key in enumerate(own.tolist()):
            rank = p + sum(int((other > np.uint64(key)).sum())
                           for o, other in enumerate(chunks) if o != c)
            if rank < k and key >> 32 != NAN_KEY:
                values[rank], indices[rank] = _value(key), _index(key)
                below[_index(key)] = 0.0
    return below.reshape(x.shape), values, indices, count


def _sort_chunk(keys: np.ndarray) -> np.ndarray:
    """A chunk sorted descending as the kernel sorts it: padded with 0 to a
    power of two of at least 32, each warp's 32 sorted, then runs merged
    pairwise, a key's place being its own in its run plus the other run's
    keys above it (at least it, for a key of the right run); a pad goes
    after the other run's keys (left) or after the whole left run
    (right)."""
    p2 = 32
    while p2 < keys.size:
        p2 *= 2
    buf = np.zeros(p2, np.uint64)
    buf[:keys.size] = keys
    buf = np.concatenate([np.sort(buf[w:w + 32])[::-1]
                          for w in range(0, p2, 32)])
    w = 32
    while w < p2:
        out = np.zeros_like(buf)
        placed = np.zeros(p2, bool)
        for t in range(p2):
            start, left = t & ~(2 * w - 1), (t & w) == 0
            first = start + (w if left else 0)
            real = min(max(keys.size - first, 0), w)  # the other run's keys
            other = buf[first:first + real]
            if buf[t] == 0:  # a pad: after the other run's keys, or all
                above = real if left else w
            else:
                above = int((other > buf[t]).sum() if left
                            else (other >= buf[t]).sum())
            place = t - start - (0 if left else w) + above
            assert not placed[start + place]
            placed[start + place] = True
            out[start + place] = buf[t]
        buf, w = out, w * 2
    assert (np.diff(buf.astype(np.float64)) <= 0).all()
    return buf[:keys.size]


def _normal(rng, shape, scale=1.0, bf16=True):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    if bf16:  # the split engine's payload is a bf16 hidden state as f32
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _outliers(rng, shape, m, lo=6.0, hi=60.0):
    """|x| < 5 but for ``m`` entries of |x| in [lo, hi)."""
    x = np.clip(_normal(rng, shape), -4.0, 4.0)
    flat = x.reshape(-1)
    at = rng.choice(flat.size, m, replace=False)
    flat[at] = rng.uniform(lo, hi, m).astype(np.float32) * rng.choice(
        [-1, 1], m)
    return x


def _ties_across_tiles(rng, shape):
    """40 entries of |x| = 7 spread over every tile, and 6 larger: the
    C-th (16th) candidate is a 7 and the ties straddle tiles."""
    x = np.clip(_normal(rng, shape), -4.0, 4.0)
    flat = x.reshape(-1)
    at = rng.choice(flat.size, 46, replace=False)
    flat[at[:40]] = 7.0 * rng.choice([-1, 1], 40)
    flat[at[40:]] = [9.0, -11.0, 9.0, 30.0, -9.0, 12.0]
    return x


def _nans(rng, shape):
    x = _outliers(rng, shape, 30)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, 3, replace=False)] = np.nan
    return x


# name: (shape, tau, capacity, inputs)
CASES = {
    "count_0": ((1, 4096), 1e3, 16, lambda r, s: _normal(r, s, 3.0)),
    "count_below_C": ((1, 4096), 5.0, 16, lambda r, s: _outliers(r, s, 5)),
    "count_equals_C": ((1, 4096), 5.0, 16, lambda r, s: _outliers(r, s, 16)),
    "count_far_above_C": ((7, 100), 0.5, 16, lambda r, s: _normal(r, s, 3.0)),
    "ties_across_tiles": ((3, 4096), 5.0, 16, _ties_across_tiles),
    "everything_above": ((7, 100), 0.0, 100,
                         lambda r, s: _normal(r, s, 3.0)),
    "ragged_d": ((7, 100), 2.0, 16, lambda r, s: _normal(r, s, 3.0, False)),
    "t1_payload": ((1, 4096), 5.0, 16, lambda r, s: _normal(r, s, 2.0)),
    "t7_overflow": ((7, 4096), 5.0, 72, lambda r, s: _outliers(r, s, 200)),
    "nan": ((2, 1000), 5.0, 16, _nans),
}


def _case(name):
    shape, tau, cap, make = CASES[name]
    x = make(np.random.default_rng(sorted(CASES).index(name)), shape)
    return x, tau, cap


def _reference(x, tau, cap):
    below, above = JTS.ts_encode(jnp.asarray(x), tau, cap)
    return (np.asarray(below), np.asarray(above.values),
            np.asarray(above.indices), int(above.count))


def _assert_as_reference(got, want):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


@pytest.mark.parametrize("tile,chunk", [(TILE, CHUNK)] + SMALL)
@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_equals_reference(name, tile, chunk):
    x, tau, cap = _case(name)
    want = _reference(x, tau, cap)
    for seed in (0, 1):
        got = emulate(x, tau, cap, tile, chunk, seed)
        _assert_as_reference(got, want)
    # and the port's plain version, bit for bit (+0 at the kept entries)
    plain = [t.numpy() for t in tsm.ts_encode_ref(torch.from_numpy(x), tau,
                                                  cap)]
    for g, p in zip(got[:3], plain[:3]):
        assert g.dtype == p.dtype and g.shape == p.shape
        np.testing.assert_array_equal(g.view(np.uint8), p.view(np.uint8))
    assert got[3] == int(plain[3])


@pytest.mark.parametrize("name", sorted(CASES))
def test_ops_ts_encode_on_cpu_equals_reference(name):
    x, tau, cap = _case(name)
    got = ops.ts_encode(torch.from_numpy(x), tau, cap)
    assert [t.dtype for t in got] == [torch.float32, torch.float32,
                                      torch.int64, torch.int32]
    assert got[0].shape == x.shape and got[3].shape == ()
    _assert_as_reference([t.numpy() for t in got[:3]] + [int(got[3])],
                         _reference(x, tau, cap))


def test_grid_reaches_each_case():
    """The grid holds what its names say: the count against the capacity,
    ties at the C-th magnitude in every tile (kept by index), and NaNs at
    the head of the carrier."""
    counts = {}
    for name in CASES:
        x, tau, cap = _case(name)
        counts[name] = emulate(x, tau, cap)[3]
    assert counts["count_0"] == 0
    assert counts["count_below_C"] == 5
    assert counts["count_equals_C"] == 16
    assert counts["count_far_above_C"] > 10 * 16
    assert counts["everything_above"] == 700
    x, tau, cap = _case("ties_across_tiles")
    sevens = np.nonzero(np.abs(x.reshape(-1)) == 7.0)[0]
    assert len(set(sevens // TILE)) == 3
    indices = emulate(x, tau, cap)[2]
    assert sorted(indices[6:].tolist()) == sorted(sevens[:10].tolist())
    x, tau, cap = _case("nan")
    indices = emulate(x, tau, cap)[2]
    assert indices[:3].tolist() == [-1] * 3 and (indices[3:] >= 0).all()


def test_emulation_sizes_are_the_kernels():
    """The emulation's tile and chunk are the kernel source's, and the
    wrapper's bound on T * D is ``kMaxN``."""
    from repro_torch.kernels import build

    src = (build.CSRC / "ts_mask.cu").read_text()
    assert f"constexpr int kTile = {TILE};" in src
    assert "constexpr int kThreads = 1024;" in src and CHUNK == 1024
    assert "constexpr int kChunk = kThreads;" in src
    assert "kMaxN = 0x7fffffffLL - kTile;" in src
    assert tsm.MAX_N == 0x7FFFFFFF - TILE

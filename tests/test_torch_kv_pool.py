"""The port's paged KV pool against the reference pool: every case runs the
same operations on both (``_Twin``) and holds the port to the reference's
host state (block tables, refcounts, lengths, free list) and device state
(codes, scales, positions) after each of them. Mirrors the allocator,
refcount, copy-on-write, ``share_prefix``/``release_prefix``, scrub-on-free
and ``can_admit`` cases of ``tests/test_kv_pool.py``, and its randomized
walk without ``truncate``, swap or ``mesh``."""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.serving import kv_pool as JP
from repro_torch.configs import get_config
from repro_torch.serving import kv_pool as TP

torch.set_num_threads(2)

CFG = get_config("llama2-7b-tiny")
JCFG = jax_config("llama2-7b-tiny")


class _Twin:
    """The reference pool and the port's, driven by the same calls. The
    tiny config has one pattern position, so the reference's leaves
    (num_blocks, P, ...) and the port's (layers, P, ...) share a shape."""

    def __init__(self, **kw):
        self.ref = JP.PagedKVPool(JCFG, **kw)
        self.port = TP.PagedKVPool(CFG, device="cpu", **kw)
        self.handles = []  # (reference handle, port handle)

    def __getattr__(self, name):
        """Call ``name`` on both pools; both must agree on the outcome."""
        def both(*args, **kw):
            out, err = [], []
            for pool in (self.ref, self.port):
                try:
                    out.append(getattr(pool, name)(*args, **kw))
                    err.append(None)
                except (ValueError, AssertionError,
                        RuntimeError) as e:  # PoolExhaustedError included
                    out.append(None)
                    err.append(type(e).__name__)
            assert err[0] == err[1], (name, err)
            if err[0] is not None:
                raise {"PoolExhaustedError": TP.PoolExhaustedError,
                       "AssertionError": AssertionError}.get(
                           err[0], ValueError)(err[0])
            return out[1] if not isinstance(out[1], TP.SharedPrefix) \
                else self._pair(*out)
        return both

    def _pair(self, jh, th):
        assert jh.pages == th.pages and jh.n_tokens == th.n_tokens
        self.handles.append((jh, th))
        return len(self.handles) - 1

    def admit(self, n, reserve_tokens=None, prefix=None):
        jh = th = None
        if prefix is not None:
            jh, th = self.handles[prefix]
        slots = []
        errs = []
        for pool, h in ((self.ref, jh), (self.port, th)):
            try:
                slots.append(pool.admit(n, reserve_tokens, prefix=h))
                errs.append(None)
            except JP.PoolExhaustedError:
                errs.append("exhausted")
            except TP.PoolExhaustedError:
                errs.append("exhausted")
        assert errs[0] == errs[1]
        if errs[0]:
            raise TP.PoolExhaustedError("exhausted")
        assert slots[0] == slots[1]
        return slots[1]

    def can_admit(self, n, prefix=None):
        jh = th = None
        if prefix is not None:
            jh, th = self.handles[prefix]
        a, b = self.ref.can_admit(n, jh), self.port.can_admit(n, th)
        assert a == b
        return b

    def release_prefix(self, i):
        jh, th = self.handles[i]
        self.ref.release_prefix(jh)
        self.port.release_prefix(th)

    def write(self, slot, lo, hi, rng):
        """Emulate a prefill/decode writing positions ``lo .. hi - 1`` of
        ``slot``: the same random codes, scales and positions land in both
        pools' pages (the model's scatter is held bit for bit in
        ``tests/test_torch_paged_kernels.py``)."""
        if hi <= lo:
            return
        ps = self.port.page_size
        t = np.arange(lo, hi)
        pr = self.port.block_tables[slot][t // ps]
        assert (pr != 0).all()
        sl = t % ps
        n, nl = t.size, self.port.num_layers
        kh, hd = self.port.kv_heads, self.port.head_dim
        codes = rng.integers(-127, 128, (2, n, nl, kh, hd)).astype(np.int8)
        scales = rng.uniform(1e-3, 2e-2, (2, n, nl, kh)).astype(np.float32)
        # adjacent index arrays keep their place: (layers, n) positions
        pos = np.broadcast_to(t[None, :], (nl, n)).astype(np.int32)
        c = self.ref._caches[0]
        self.ref._caches = (type(c)(
            c.k.at[:, pr, :, sl, :].set(codes[0]),
            c.v.at[:, pr, :, sl, :].set(codes[1]),
            c.k_scale.at[:, pr, :, sl].set(scales[0]),
            c.v_scale.at[:, pr, :, sl].set(scales[1]),
            c.pos.at[:, pr, sl].set(pos), c.block_table),)
        p = self.port
        p.k[:, pr, :, sl, :] = torch.from_numpy(codes[0])
        p.v[:, pr, :, sl, :] = torch.from_numpy(codes[1])
        p.k_scale[:, pr, :, sl] = torch.from_numpy(scales[0])
        p.v_scale[:, pr, :, sl] = torch.from_numpy(scales[1])
        p.pos[:, pr, sl] = torch.from_numpy(pos)

    def check(self, device=True):
        """Host state equal; with ``device``, every pool leaf equal."""
        j, t = self.ref, self.port
        np.testing.assert_array_equal(t.block_tables, j.block_tables)
        np.testing.assert_array_equal(t.refcount, j.refcount)
        np.testing.assert_array_equal(t.lengths, j.lengths)
        np.testing.assert_array_equal(t.active, j.active)
        assert t._free == j._free
        assert (t.pages_in_use, t.pages_shared, t.free_pages) == (
            j.pages_in_use, j.pages_shared, j.free_pages)
        assert t.page_bytes_in_use() == j.page_bytes_in_use()
        assert t.eq2_bytes() == j.eq2_bytes()
        assert t.occupancy() == j.occupancy()
        if device:
            c = j._caches[0]
            for name in ("k", "v", "k_scale", "v_scale", "pos"):
                np.testing.assert_array_equal(
                    getattr(t, name).numpy(), np.asarray(getattr(c, name)),
                    err_msg=name)


def _filled(twin, n, rng, **kw):
    """Admit ``n`` tokens, write them, commit the prefill."""
    s = twin.admit(n, **kw)
    twin.write(s, int(twin.port.lengths[s]), n, rng)
    twin.commit_prefill(s, n)
    return s


# ------------------------------------------------------------- allocator


def test_alloc_free_reuse_ordering():
    twin = _Twin(num_pages=16, page_size=4, max_requests=3)
    a = twin.admit(6)
    b = twin.admit(4)
    pages_a = [p for p in twin.port.block_tables[a] if p]
    assert len(pages_a) == 2 and len([p for p in twin.port.block_tables[b]
                                      if p]) == 1
    twin.free(a)
    c = twin.admit(8)  # LIFO: a's pages come back, last freed first
    assert {p for p in twin.port.block_tables[c] if p} == set(pages_a)
    twin.check()


def test_pool_and_slot_exhaustion():
    twin = _Twin(num_pages=4, page_size=4, max_requests=2)  # 3 usable
    twin.admit(12)
    with pytest.raises(TP.PoolExhaustedError):
        twin.admit(4)
    assert not twin.can_admit(4)
    twin.free(0)
    twin.admit(4)
    twin.admit(4)
    with pytest.raises(TP.PoolExhaustedError):
        twin.admit(1)  # both slots active
    assert not twin.can_admit(1)
    twin.check()


def test_append_across_page_boundary_and_max_blocks():
    twin = _Twin(num_pages=16, page_size=4, max_requests=3, max_seq_len=8)
    s = twin.admit(4)
    twin.commit_prefill(s, 4)
    before = twin.port.pages_in_use
    twin.append(s, 1)
    assert twin.port.pages_in_use == before + 1
    twin.append(s, 3)
    with pytest.raises(TP.PoolExhaustedError):
        twin.append(s, 1)  # past max_blocks: a clean error
    twin.check()


def test_free_scrubs_positions_on_device():
    rng = np.random.default_rng(0)
    twin = _Twin(num_pages=16, page_size=4, max_requests=3)
    s = _filled(twin, 7, rng)
    pages = [int(p) for p in twin.port.block_tables[s] if p]
    twin.check()
    twin.free(s)
    assert (twin.port.pos[:, pages] == -1).all()  # stale tokens unreachable
    twin.check()


def test_occupancy_and_eq2_accounting():
    rng = np.random.default_rng(1)
    twin = _Twin(num_pages=9, page_size=4, max_requests=3)
    assert twin.port.occupancy() == 0.0 and twin.port.eq2_bytes() == 0
    s = _filled(twin, 6, rng)
    assert twin.port.occupancy() == pytest.approx(2 / 8)
    assert twin.port.eq2_bytes() > 0
    g = twin.port.gauges()
    assert g["pages_in_use"] + g["pages_free"] == 8
    twin.check()
    twin.free(s)
    assert twin.port.occupancy() == 0.0 and twin.port.eq2_bytes() == 0


# --------------------------------------------------- prefix sharing / CoW


def test_share_prefix_fork_refcounts_and_cow():
    rng = np.random.default_rng(2)
    twin = _Twin(num_pages=16, page_size=4, max_requests=3)
    a = _filled(twin, 6, rng)
    h = twin.share_prefix(a, 6)
    p0, p1 = twin.port.block_tables[a][:2]
    b = twin.admit(8, prefix=h)
    tb = twin.port.block_tables[b]
    assert tb[0] == p0 and tb[1] not in (p1, 0)  # aliased, then CoW copy
    assert twin.port.refcount[p0] == 3 and twin.port.refcount[p1] == 2
    twin.check()
    twin.free(a)
    twin.free(b)
    twin.release_prefix(h)
    twin.check()
    assert twin.port.pages_in_use == 0 and not twin.port.refcount.any()
    twin.release_prefix(h)  # idempotent


def test_cow_copy_scrubs_foreign_positions():
    """The copy keeps only positions below the forker's length; the
    creator's later tokens in the boundary page are scrubbed in the copy,
    and the codes and scales are copied with it."""
    rng = np.random.default_rng(3)
    twin = _Twin(num_pages=16, page_size=4, max_requests=3)
    a = _filled(twin, 8, rng)
    h = twin.share_prefix(a, 6)
    b = twin.admit(7, prefix=h)
    cow = int(twin.port.block_tables[b][1])
    np.testing.assert_array_equal(twin.port.pos[:, cow].numpy(),
                                  np.tile([4, 5, -1, -1], (2, 1)))
    p1 = int(twin.port.block_tables[a][1])
    np.testing.assert_array_equal(twin.port.k[:, cow].numpy(),
                                  twin.port.k[:, p1].numpy())
    twin.check()


def test_cow_on_append_into_shared_page():
    rng = np.random.default_rng(4)
    twin = _Twin(num_pages=16, page_size=4, max_requests=3)
    a = _filled(twin, 6, rng)
    twin.share_prefix(a, 6)
    p1 = int(twin.port.block_tables[a][1])
    twin.append(a, 1)  # the creator's next write lands in the shared page
    assert int(twin.port.block_tables[a][1]) != p1
    assert twin.port.refcount[p1] == 1  # the handle only
    twin.check()


def test_aligned_prefix_forks_without_cow():
    rng = np.random.default_rng(5)
    twin = _Twin(num_pages=16, page_size=4, max_requests=3)
    a = _filled(twin, 8, rng)
    h = twin.share_prefix(a, 8)
    before = twin.port.pages_in_use
    b = twin.admit(9, prefix=h)
    assert twin.port.pages_in_use == before + 1  # one suffix page, no copy
    assert tuple(twin.port.block_tables[b][:2]) == \
        twin.handles[h][1].pages
    twin.check()


def test_fork_admission_is_atomic_on_exhaustion():
    rng = np.random.default_rng(6)
    twin = _Twin(num_pages=4, page_size=4, max_requests=3)  # 3 usable
    a = _filled(twin, 6, rng)
    h = twin.share_prefix(a, 6)
    assert not twin.can_admit(10, prefix=h)
    with pytest.raises(TP.PoolExhaustedError):
        twin.admit(10, prefix=h)  # CoW + one suffix page, one free
    assert not twin.port.active[1:].any()
    twin.check()


def test_double_free_is_an_assert_and_bad_pools_raise():
    twin = _Twin(num_pages=16, page_size=4, max_requests=3)
    a = twin.admit(4)
    twin.free(a)
    with pytest.raises(AssertionError):
        twin.free(a)
    with pytest.raises(AssertionError, match="double free"):
        twin.port._decref([int(twin.port._free[-1])])
    for kw in (dict(page_size=0), dict(num_pages=1)):
        with pytest.raises(ValueError):
            TP.PagedKVPool(CFG, **{"num_pages": 8, "page_size": 4,
                                   "max_requests": 1, **kw}, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        TP.PagedKVPool(get_config("llama2-7b-tiny").__class__(
            **{**CFG.__dict__, "pattern": (CFG.pattern[0].__class__(
                CFG.pattern[0].mixer.__class__(4, 2, 32, sliding_window=8),
                CFG.pattern[0].ffn),)}), num_pages=8, page_size=4,
            max_requests=1, device="cpu")
    # mesh= is ported (tests/test_torch_sharded.py): what is not a
    # ("kv", "model") DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        TP.PagedKVPool(CFG, num_pages=8, page_size=4, max_requests=1,
                       mesh=object(), device="cpu")


def test_device_caches_and_gather_dense_match_reference():
    """Per-layer views share one uploaded block table; a slot gathered
    dense equals the reference's gather."""
    rng = np.random.default_rng(7)
    twin = _Twin(num_pages=16, page_size=4, max_requests=3)
    _filled(twin, 5, rng)
    s = _filled(twin, 9, rng)
    caches = twin.port.device_caches(rows=[s])
    assert len(caches) == twin.port.num_layers
    assert all(c.block_table is caches[0].block_table for c in caches)
    np.testing.assert_array_equal(caches[0].block_table.numpy(),
                                  twin.port.block_tables[[s]])
    assert caches[1].k.data_ptr() == twin.port.k[1].data_ptr()  # a view
    want = twin.ref.gather_dense(s)[0]  # (k, v, k_scale, v_scale, pos)
    k, ks, v, vs, pos = twin.port.gather_dense(s)
    for got, w in ((k, want[0]), (v, want[1]), (ks, want[2]),
                   (vs, want[3]), (pos, want[4])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


# --------------------------------------------------- randomized invariants


def test_random_admit_fork_append_free_walk_matches_reference():
    """A random walk over admit / share / fork / append / free / release,
    writing each admitted and appended token, with host state compared
    after every operation and device state every few."""
    rng = np.random.default_rng(12345)
    twin = _Twin(num_pages=20, page_size=4, max_requests=5)
    for step in range(200):
        op = int(rng.integers(0, 5))
        active = [int(s) for s in np.flatnonzero(twin.port.active)]
        live = [i for i, (_, th) in enumerate(twin.handles)
                if not th.released]
        try:
            if op == 0:
                if live and rng.random() < 0.5:
                    h = live[int(rng.integers(len(live)))]
                    n = twin.handles[h][1].n_tokens + int(rng.integers(1, 9))
                    _filled(twin, n, rng, prefix=h)
                else:
                    _filled(twin, int(rng.integers(1, 17)), rng)
            elif op == 1 and active:
                s = active[int(rng.integers(len(active)))]
                length = int(twin.port.lengths[s])
                if length >= 2:
                    twin.share_prefix(s, int(rng.integers(1, length)))
            elif op == 2 and active:
                s = active[int(rng.integers(len(active)))]
                n = int(rng.integers(1, 4))
                lo = int(twin.port.lengths[s])
                twin.append(s, n)
                twin.write(s, lo, lo + n, rng)
            elif op == 3 and active:
                twin.free(active[int(rng.integers(len(active)))])
            elif op == 4 and twin.handles:
                twin.release_prefix(int(rng.integers(len(twin.handles))))
        except TP.PoolExhaustedError:
            pass  # backpressure, with no state change on either side
        twin.check(device=step % 10 == 0)
    for s in np.flatnonzero(twin.port.active):
        twin.free(int(s))
    for i in range(len(twin.handles)):
        twin.release_prefix(i)
    twin.check()
    assert twin.port.pages_in_use == 0
    assert twin.port.free_pages == twin.port.num_pages - 1

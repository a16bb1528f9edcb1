"""The port's sharded serving deployment on the CPU (``launch.mesh``,
``launch.collectives``, ``launch.ranks``, ``PagedKVPool(mesh=)``,
``transformer.sharded_step_fns``, ``Scheduler(mesh=)``,
``LLMServer(deployment="sharded")``), one gloo rank a process, held to the
reference's bar (``tests/test_sharded_serving.py``): on its workload
(``_workload(seed=7)`` through ``_drive``, a 24-page pool that forces
preemption with swap), every cell of the grid of 1, 2 and 4 ranks × the
packed, chunked and wave ticks × ``speculate_k`` 0 and 2, and granite-34b
``tiny()`` (one kv head: a (4, 1) mesh) at 4 ranks, gives the greedy
streams of the reference's ``Engine.generate`` on the bridged
``init_params(PRNGKey(0))`` weights. In each cell every rank returns the
same streams and the same host state after every tick, the pool drains,
packed at k 0 keeps one step shape and each rank stores ⌈P/kv⌉ pages.
Then the pool's randomized walk on a 2-rank pool against an unsharded
one, head-group outputs of K2's, K3's and K4's layers and plain kernels
against the same rows of the all-heads outputs bit for bit, the mesh
rule, and the deployment knob.

Every world of ranks is spawned once (all four at the same time) and its
cells are asserted one by one."""

import concurrent.futures
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import AttnSpec
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (make_serving_mesh, mesh_coords,
                                     serving_mesh_shape)
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import layers as L
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.serving.api import LLMServer, SamplingParams
from repro_torch.serving.async_engine import AsyncLLMServer
from repro_torch.serving.kv_pool import PagedKVPool, PoolExhaustedError
from repro_torch.serving.scheduler import Scheduler

torch.set_num_threads(2)

OPTS_Q = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
# the reference grid's pool: 24 pages of 4 tokens, 3 slots, lazy growth
POOL = dict(num_pages=24, page_size=4, max_slots=3, lazy_growth=True)
CELLS = [(mode, k) for mode in ("packed", "chunked", "wave") for k in (0, 2)]
GRID = [(n, mode, k) for n in (1, 2, 4) for mode, k in CELLS]
# (config, ranks) of each world spawned
WORLDS = [("llama2-7b", 1), ("llama2-7b", 2), ("llama2-7b", 4),
          ("granite-34b", 4)]
KNOB_PROMPT = np.arange(2, 9, dtype=np.int32)
# speculation's own run in each k 2 cell: a prompt holding every token of
# the tiny vocabulary, so that prompt lookup drafts at every decode tick
# whatever the model samples (the reference's workload draws no draft
# from these weights on some hosts: its own d1-*-k2 cells fail there)
SPEC_PROMPT = np.random.default_rng(3).permutation(256).astype(np.int32)
SPEC_NEW = 8
SPEC_POOL = dict(num_pages=24, page_size=16, max_slots=3)


# ------------------------------------------------------------- the ranks


def _digest(sched) -> str:
    """The host state every rank must agree on after a tick."""
    p = sched.pool
    h = hashlib.sha256()
    for a in (p.block_tables, p.refcount, p.lengths, p.active):
        h.update(np.ascontiguousarray(a).tobytes())
    slots = [None if st is None else (st.req.rid, st.prefilled,
                                      tuple(st.generated))
             for st in sched.slots]
    h.update(repr((p._free, p.swap_bytes, slots,
                   [r.rid for r in sched.queue])).encode())
    return h.hexdigest()


def _serve_cell(cfg, params, mesh, jobs, mode, k) -> dict:
    from test_sharded_serving import _drive

    sched = Scheduler(cfg, params, OPTS_Q, tick_mode=mode, speculate_k=k,
                      mesh=mesh, device="cpu", **POOL)
    digests, step = [], sched.step

    def traced():
        out = step()
        digests.append(_digest(sched))
        return out

    sched.step = traced
    rids = _drive(sched, jobs)
    seen, in_order = {}, True
    for rid, idx, _, lp in sched.drain_events():
        in_order &= idx == seen.get(rid, -1) + 1 and bool(np.isfinite(lp))
        seen[rid] = idx
    st = sched.stats
    return {"streams": [sched.results[rids[j]] for j in range(len(jobs))],
            "digests": digests, "events_in_order": in_order,
            "pages_in_use": sched.pool.pages_in_use,
            "swap_bytes": sched.pool.swap_bytes,
            "shard_pages": tuple(sched.pool.k.shape[:2]),
            "num_pages": sched.pool.num_pages,
            "gauges": sched.pool.gauges(), "packed_ticks": st.packed_ticks,
            "compiled_shapes": st.compiled_shapes,
            "spec_rounds": st.spec_rounds, "evicted": st.evicted,
            "spec": _spec_run(cfg, params, mesh, mode, k) if k else None}


def _spec_run(cfg, params, mesh, mode, k) -> dict:
    """:data:`SPEC_PROMPT` through a sharded scheduler at ``speculate_k``
    k: its stream and the verify rounds that carried drafts."""
    sched = Scheduler(cfg, params, OPTS_Q, tick_mode=mode, speculate_k=k,
                      mesh=mesh, device="cpu", **SPEC_POOL)
    rid = sched.submit(SPEC_PROMPT, SPEC_NEW)
    return {"stream": sched.run()[rid], "spec_rounds": sched.stats.spec_rounds,
            "pages_in_use": sched.pool.pages_in_use}


def _knob(cfg, params, mesh) -> dict:
    """``LLMServer(deployment="sharded")`` over the default group's mesh,
    and ``mesh=`` refused by the other deployments."""
    srv = LLMServer(cfg, params, OPTS_Q, backend="paged",
                    deployment="sharded", device="cpu", **POOL)
    rid = srv.submit(KNOB_PROMPT, SamplingParams(max_tokens=4))
    out = {"tokens": srv.run()[rid].tokens,
           "has_mesh": srv.backend.scheduler.mesh is not None,
           "mesh_shape": tuple(srv.backend.scheduler.mesh.shape)}
    for dep in ("fused", "disaggregated"):
        try:
            LLMServer(cfg, params, OPTS_Q, backend="paged", deployment=dep,
                      mesh=mesh, device="cpu", **POOL)
            out[dep] = None
        except ValueError as e:
            out[dep] = str(e)
    try:
        AsyncLLMServer(srv)
        out["async"] = None
    except NotImplementedError as e:
        out["async"] = str(e)
    return out


def _layer_inputs(seed: int, kh: int = 4, g: int = 2, hd: int = 16,
                  page: int = 4, nb: int = 4, lens=(5, 11, 16)):
    """A pool of random int8 pages with each row's positions 0..len-1
    through its block table, and the AttnSpec of ``kh`` kv heads of
    ``g`` query heads each."""
    gen = torch.Generator().manual_seed(seed)
    r = len(lens)
    p = r * nb + 1
    codes = lambda: torch.randint(-127, 128, (p, kh, page, hd),
                                  generator=gen, dtype=torch.int8)
    scales = lambda: torch.rand((p, kh, page), generator=gen) * 0.02 + 1e-3
    k, v, ks, vs = codes(), codes(), scales(), scales()
    pos = torch.full((p, page), -1, dtype=torch.int32)
    bt = torch.arange(1, p, dtype=torch.int32).reshape(r, nb)
    for row, n in enumerate(lens):
        for t in range(n):
            pos[bt[row, t // page], t % page] = t
    cache = L.PagedKVCache(k, v, ks, vs, pos, bt)
    return gen, cache, AttnSpec(kh * g, kh, hd), torch.tensor(lens)


def _layer_calls(seed: int) -> dict:
    """K2's (decode and a 2-column verify), K3's and K4's layers on the
    same inputs: name → a function of (head_axis, head_shards)."""
    gen, cache, spec, lens = _layer_inputs(seed)
    r, h, kh, hd = lens.numel(), spec.num_heads, spec.num_kv_heads, \
        spec.head_dim
    rnd = lambda *shape: torch.randn(shape, generator=gen)
    dec_q, ver_q = rnd(r, 1, h, hd), rnd(r, 2, h, hd)
    ver_pos = torch.stack([lens - 2, lens - 1], 1).int()
    s = 3  # K3: a 3-token chunk a row past its history
    pre_q, pre_k, pre_v = rnd(r, s, h, hd), rnd(r, s, kh, hd), \
        rnd(r, s, kh, hd)
    pre_pos = (lens[:, None] + torch.arange(s)).int()
    # K4: slot 0 decodes one token, slot 1 a 3-token chunk, 2 pad rows
    slots = torch.tensor([[0, 1, 1, 1, -1, -1]], dtype=torch.int32)
    vpos = torch.tensor([[int(lens[0]), int(lens[1]), int(lens[1]) + 1,
                          int(lens[1]) + 2, -1, -1]], dtype=torch.int32)
    t = slots.shape[1]
    var_q, var_k, var_v = rnd(1, t, h, hd), rnd(1, t, kh, hd), \
        rnd(1, t, kh, hd)
    packed = L.packed_layout(vpos, slots, r, None)
    return {
        "K2_decode": lambda **hx: L.paged_decode_attention_layer(
            dec_q, cache, spec, (lens - 1).int()[:, None], **hx),
        "K2_verify": lambda **hx: L.paged_decode_attention_layer(
            ver_q, cache, spec, ver_pos, **hx),
        "K3": lambda **hx: L.paged_prefill_attention(
            pre_q, cache, pre_k, pre_v, spec, pre_pos, **hx),
        "K4": lambda **hx: L.varlen_attention_layer(
            var_q, cache, var_k, var_v, spec, vpos, packed, **hx)}


def _head_group_layers(mesh) -> dict:
    """Each layer with its kv heads split over the mesh's ``model`` dim
    against the same layer on every head: bit for bit."""
    _, size, group = mesh_coords(mesh)["model"]
    return {name: bool(torch.equal(
        call(head_axis=group, head_shards=size), call()))
        for name, call in _layer_calls(seed=5).items()}


def _world_rank(rank, world, name, params, jobs) -> dict:
    torch.set_num_threads(1)
    cfg = get_config(name).tiny()
    mesh = make_serving_mesh(cfg.pattern[0].mixer.num_kv_heads)
    out = {"mesh": tuple(mesh.shape),
           "cells": {c: _serve_cell(cfg, params, mesh, jobs, *c)
                     for c in (CELLS if name == "llama2-7b"
                               else [("packed", 0)])}}
    if name == "llama2-7b":
        out["knob"] = _knob(cfg, params, mesh)
    if out["mesh"][1] > 1:
        out["head_groups"] = _head_group_layers(mesh)
    return out


def _walk_rank(rank, world, seed) -> dict:
    """The pool's randomized walk (admit, fork, append with writes,
    truncate, swap out and back, free, release) on a mesh pool beside an
    unsharded one given the same calls and the same bytes: after every
    step the host state is equal, this rank's leaves are its slice of the
    unsharded pool's, and every active slot gathers (across ranks) equal
    to the unsharded pool's."""
    torch.set_num_threads(1)
    cfg = get_config("llama2-7b").tiny()
    mesh = make_serving_mesh(cfg.pattern[0].mixer.num_kv_heads)
    kw = dict(num_pages=20, page_size=4, max_requests=4, device="cpu")
    pools = (PagedKVPool(cfg, mesh=mesh, **kw), PagedKVPool(cfg, **kw))
    sh, flat = pools
    rng = np.random.default_rng(seed)
    handles, snaps, ops_done = [], [], set()
    copy_page = sh._copy_page

    def counted_copy(*args, **kw):
        ops_done.add("cow")
        return copy_page(*args, **kw)

    sh._copy_page = counted_copy

    def write(slot, lo, hi):
        """The same random codes, scales and positions for tokens lo..hi-1
        into both pools, each writing the pages it stores."""
        t = np.arange(lo, hi)
        pr = flat.block_tables[slot][t // flat.page_size]
        n, nl = t.size, flat.num_layers
        kh, hd = flat.kv_heads, flat.head_dim
        # (token, layer, ...) for the split page/slot index, as the
        # pool's leaves read under it; positions (layer, token)
        code = lambda: torch.from_numpy(
            rng.integers(-127, 128, (n, nl, kh, hd)).astype(np.int8))
        scale = lambda: torch.from_numpy(
            rng.uniform(1e-3, 2e-2, (n, nl, kh)).astype(np.float32))
        data = (code(), code(), scale(), scale(), torch.from_numpy(
                    np.broadcast_to(t, (nl, n)).astype(np.int32).copy()))
        for pool in pools:
            rows, local = pool._own(pr)
            if not rows:
                continue
            page = torch.as_tensor(local)
            sl = torch.as_tensor(t[rows] % flat.page_size)
            for leaf, d in zip(pool._leaves()[:4], data[:4]):
                leaf[:, page, :, sl] = d[rows]
            pool.pos[:, page, sl] = data[4][:, rows]

    def both(fn):
        res = []
        for pool in pools:
            try:
                res.append(("ok", fn(pool)))
            except (PoolExhaustedError, ValueError) as e:
                res.append(("err", type(e).__name__))
        assert res[0][0] == res[1][0], res
        if res[0][0] == "err":
            raise PoolExhaustedError(res[0][1])
        return res[0][1], res[1][1]

    for _ in range(120):
        op = int(rng.integers(0, 7))
        active = [int(s) for s in np.flatnonzero(flat.active)]
        try:
            if op == 0:
                n = int(rng.integers(1, 13))
                live = [h for h in handles if not h[1].released]
                if live and rng.random() < 0.5:
                    hs, hf = live[int(rng.integers(len(live)))]
                    n += hf.n_tokens
                    s, _ = both(lambda p: p.admit(
                        n, prefix=hs if p is sh else hf))
                else:
                    s, _ = both(lambda p: p.admit(n))
                write(s, int(flat.lengths[s]), n)
                both(lambda p: p.commit_prefill(s, n))
            elif op == 1 and active:
                s = active[int(rng.integers(len(active)))]
                if int(flat.lengths[s]) >= 2:
                    m = int(rng.integers(1, int(flat.lengths[s])))
                    handles.append(both(lambda p: p.share_prefix(s, m)))
            elif op == 2 and active:
                s = active[int(rng.integers(len(active)))]
                lo, n = int(flat.lengths[s]), int(rng.integers(1, 4))
                both(lambda p: p.append(s, n))
                write(s, lo, lo + n)
            elif op == 3 and active:
                s = active[int(rng.integers(len(active)))]
                length = int(flat.lengths[s])
                m = int(rng.integers(1, length + 1))
                both(lambda p: p.truncate(s, m))
                ops_done.add("truncate")
            elif op == 4 and active:
                s = active[int(rng.integers(len(active)))]
                snaps.append(both(lambda p: p.export_slot(s)))
                for a, b in zip(*(snap["data"] for snap in snaps[-1])):
                    assert torch.equal(a, b)
                both(lambda p: p.free(s))
            elif op == 5 and snaps:
                pair = snaps.pop(int(rng.integers(len(snaps))))
                try:
                    both(lambda p: p.restore_slot(pair[0 if p is sh else 1]))
                    ops_done.add("restore")
                except PoolExhaustedError:
                    snaps.append(pair)
            elif op == 6 and active:
                s = active[int(rng.integers(len(active)))]
                both(lambda p: p.free(s))
        except PoolExhaustedError:
            pass
        for name in ("block_tables", "refcount", "lengths", "active"):
            np.testing.assert_array_equal(getattr(sh, name),
                                          getattr(flat, name))
        assert sh._free == flat._free and sh.swap_bytes == flat.swap_bytes
        lo, n = sh._first_page, sh.shard_pages
        for a, b in zip(sh._leaves(), flat._leaves()):
            assert torch.equal(a, b[:, lo:lo + n])
        for s in np.flatnonzero(flat.active):
            for a, b in zip(sh.gather_dense(int(s)),
                            flat.gather_dense(int(s))):
                assert torch.equal(a, b)
    return {"shard": tuple(sh.k.shape[:2]), "num_pages": sh.num_pages,
            "ops": sorted(ops_done), "gauges": sh.gauges()}


# ------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def bridged():
    """name → (the port's config, the reference's config, the reference's
    ``init_params(PRNGKey(0))``, the same weights bridged)."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    from repro_torch.params import from_jax_params

    out = {}
    for name in ("llama2-7b", "granite-34b"):
        jcfg = jax_config(name).tiny()
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        out[name] = (get_config(name).tiny(), jcfg, jparams,
                     from_jax_params(jax.tree.map(np.asarray, jparams)))
    return out


@pytest.fixture(scope="module")
def oracle(bridged):
    """The reference's per-request greedy ``Engine.generate``, memoized:
    (config name, prompt, max_new) → the stream, prompt included."""
    from repro.models import transformer as JT
    from repro.serving.engine import Engine

    opts = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                          quantized_kv=True, moe_capacity_factor=0.0)
    engines, cache = {}, {}

    def get(name, prompt, max_new):
        key = (name, prompt.tobytes(), max_new)
        cache_len = 64 if prompt.size + max_new <= 64 else 320
        if key not in cache:
            if (name, cache_len) not in engines:
                _, jcfg, jparams, _ = bridged[name]
                engines[name, cache_len] = Engine(jcfg, jparams, opts,
                                                  cache_len=cache_len)
            cache[key] = np.asarray(engines[name, cache_len].generate(
                prompt[None], max_new).tokens[0])
        return cache[key]

    return get


@pytest.fixture(scope="module")
def jobs(bridged):
    from test_sharded_serving import _workload

    return {name: _workload(bridged[name][1], seed=7) for name in bridged}


@pytest.fixture(scope="module")
def worlds(bridged, jobs, tmp_path_factory):
    """Every world of ``WORLDS`` and the 2-rank pool walk, spawned at the
    same time: (name, ranks) → each rank's results; "walk" → the walk's."""
    root = tmp_path_factory.mktemp("ranks")
    launches = {(name, n): (_world_rank, n,
                            (name, bridged[name][3], jobs[name]))
                for name, n in WORLDS}
    launches["walk"] = (_walk_rank, 2, (99,))
    with concurrent.futures.ThreadPoolExecutor(len(launches)) as ex:
        futs = {key: ex.submit(run_ranks, fn, n, backend="gloo",
                               workdir=str(root / str(i)), args=args,
                               timeout=240)
                for i, (key, (fn, n, args)) in enumerate(launches.items())}
        return {key: f.result() for key, f in futs.items()}


# ------------------------------------------------------------------ tests


def _assert_cell(ranks, name, mode, k, jobs, oracle, n):
    cells = [r["cells"][mode, k] for r in ranks]
    first = cells[0]
    for j, (prompt, max_new, _) in enumerate(jobs):
        np.testing.assert_array_equal(
            first["streams"][j], oracle(name, prompt, max_new),
            err_msg=f"job {j} diverged from the reference Engine")
    for c in cells[1:]:
        for a, b in zip(c["streams"], first["streams"]):
            np.testing.assert_array_equal(a, b)
        assert c["digests"] == first["digests"], "ranks' host state parted"
    kv = ranks[0]["mesh"][0]
    for r, c in enumerate(cells):
        assert c["events_in_order"]
        assert c["pages_in_use"] == 0 and c["swap_bytes"] == 0, "leaked"
        assert c["num_pages"] == -(-POOL["num_pages"] // kv) * kv
        assert c["shard_pages"] == (2, c["num_pages"] // kv)
        assert c["evicted"] > 0  # the grid forces preemption with swap
        g = c["gauges"]
        assert g["shard_device_bytes"] * kv == g["pool_device_bytes"]
        assert g["shard_pages_in_use"] == 0
    if mode == "packed":
        assert first["packed_ticks"] > 0
        if k == 0:  # sharding keeps the one (1, T) buffer
            assert first["compiled_shapes"] == 1
    if k:  # speculation drafted, and its stream is the Engine's
        for c in cells:
            spec = c["spec"]
            assert spec["spec_rounds"] > 0 and spec["pages_in_use"] == 0
            np.testing.assert_array_equal(
                spec["stream"], oracle(name, SPEC_PROMPT, SPEC_NEW))


@pytest.mark.parametrize("n,mode,k", GRID,
                         ids=[f"r{n}-{m}-k{k}" for n, m, k in GRID])
def test_sharded_streams_match_reference_engine(worlds, jobs, oracle, n,
                                                mode, k):
    """Each cell over n gloo ranks: the reference Engine's streams, equal
    on every rank, with the same host state after every tick; the pool
    drains; packed at k 0 keeps one step shape; each rank stores
    ⌈P/kv⌉ pages; the mesh follows the reference's rule. At k 2 a
    vocabulary-covering prompt (:data:`SPEC_PROMPT`) drafts, and its
    stream is the Engine's too."""
    ranks = worlds["llama2-7b", n]
    assert ranks[0]["mesh"] == {1: (1, 1), 2: (2, 1), 4: (2, 2)}[n]
    _assert_cell(ranks, "llama2-7b", mode, k, jobs["llama2-7b"], oracle, n)


def test_sharded_granite_one_kv_head(worlds, jobs, oracle):
    """granite-34b tiny has one kv head: 4 ranks make a (4, 1) mesh (no
    head split), pages over four ranks; the reference Engine's streams."""
    ranks = worlds["granite-34b", 4]
    assert all(r["mesh"] == (4, 1) for r in ranks)
    _assert_cell(ranks, "granite-34b", "packed", 0, jobs["granite-34b"],
                 oracle, 4)


def test_sharded_pool_walk(worlds):
    """The randomized pool walk on a 2-rank pool held to an unsharded pool
    after every step (inside the ranks); each rank stores P/kv pages and
    the walk reached CoW forks, truncates and swap restores."""
    for rank, res in enumerate(worlds["walk"]):
        assert res["num_pages"] == 20 and res["shard"] == (2, 10)
        assert {"truncate", "restore", "cow"} <= set(res["ops"])
        g = res["gauges"]
        assert g["shard_device_bytes"] * 2 == g["pool_device_bytes"]


def test_head_group_layers_bit_for_bit(worlds):
    """On the (2, 2) mesh each rank's K2 (decode and verify), K3 and K4
    layer with its kv heads split over "model" equals the all-heads call
    bit for bit (plain versions)."""
    for res in worlds["llama2-7b", 4]:
        assert res["head_groups"] == dict.fromkeys(
            ("K2_decode", "K2_verify", "K3", "K4"), True)


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("kernel", ["K2", "K3", "K4"])
def test_head_group_kernels_bit_for_bit(kernel, groups):
    """A plain kernel's output on a head group (its operands sliced to
    contiguous tensors, as the layers slice them) equals the same rows of
    its output on all heads, bit for bit."""
    gen, cache, spec, lens = _layer_inputs(seed=11)
    r, kh, hd = lens.numel(), spec.num_kv_heads, spec.head_dim
    g = spec.num_heads // kh
    rnd = lambda *shape: torch.randn(shape, generator=gen)
    pages = (cache.k, cache.k_scale, cache.v, cache.v_scale)
    if kernel == "K2":
        q, head_dim = rnd(r, kh, g, hd), 1
        call = lambda q, *pool: ops.paged_decode_attention(
            q, *pool, cache.pos, cache.block_table, (lens - 1).int())
        args = (q,)
    elif kernel == "K3":
        s = 3
        q, kf, vf = rnd(r, s, kh, g, hd), rnd(r, s, kh, hd), rnd(r, s, kh, hd)
        qp = (lens[:, None] + torch.arange(s)).int()
        call = lambda q, kf, vf, *pool: ops.paged_prefill_attention(
            q, *pool, cache.pos, cache.block_table, qp, kf, vf)
        args, head_dim = (q, kf, vf), 2
    else:
        slots = torch.tensor([0, 1, 1, 1, -1, -1], dtype=torch.int32)
        qp = torch.tensor([5, 11, 12, 13, -1, -1], dtype=torch.int32)
        t = slots.numel()
        q, kf, vf = rnd(kh, t, g, hd), rnd(kh, t, hd), rnd(kh, t, hd)
        start = ops.segment_start(qp, slots, r)
        call = lambda q, kf, vf, *pool: ops.varlen_attention(
            q, *pool, cache.pos, cache.block_table, qp, slots, start, kf, vf)
        args, head_dim = (q, kf, vf), 0
    full = call(*args, *pages)
    kl = kh // groups
    for off in range(0, kh, kl):
        part = call(*(a.narrow(head_dim, off, kl).contiguous()
                      for a in args),
                    *(leaf[:, off:off + kl].contiguous() for leaf in pages))
        assert torch.equal(part, full.narrow(head_dim, off, kl)), off


def _failing_rank(rank, world):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    return rank


def test_run_ranks_reports_a_failing_rank(tmp_path):
    """A rank that raises fails the launch with its traceback; no rank
    process outlives the call."""
    import multiprocessing

    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        run_ranks(_failing_rank, 2, backend="gloo", workdir=str(tmp_path),
                  timeout=120)
    assert not multiprocessing.active_children()
    assert run_ranks(_failing_rank, 1, backend="gloo",
                     workdir=str(tmp_path), timeout=120) == [0]


def test_serving_mesh_rule_and_no_process_group():
    """The reference's split rule; a mesh or a sharded server refused
    without an initialized process group; a pool refuses what is not a
    mesh."""
    assert [serving_mesh_shape(n, kh) for n, kh in (
        (1, 32), (2, 32), (4, 32), (4, 2), (4, 1), (4, 3), (8, 8))] == [
        (1, 1), (2, 1), (2, 2), (2, 2), (4, 1), (4, 1), (2, 4)]
    cfg = get_config("llama2-7b").tiny()
    with pytest.raises(RuntimeError, match="initialized default process"):
        make_serving_mesh(2)
    with pytest.raises(RuntimeError, match="initialized default process"):
        LLMServer(cfg, {}, OPTS_Q, backend="paged", deployment="sharded",
                  device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        PagedKVPool(cfg, num_pages=8, page_size=4, max_requests=1,
                    mesh=object(), device="cpu")


def test_server_deployment_knob(worlds, bridged, oracle):
    """``LLMServer(deployment="sharded")`` with no ``mesh=`` builds it over
    the default group (1 and 2 ranks) and serves the reference Engine's
    tokens; ``mesh=`` with the fused or disaggregated deployment raises
    ``ValueError`` naming ``deployment='sharded'``; an async front over
    a sharded server is refused, naming its ROADMAP item."""
    want = oracle("llama2-7b", KNOB_PROMPT, 4)[KNOB_PROMPT.size:]
    for n, shape in ((1, (1, 1)), (2, (2, 1)), (4, (2, 2))):
        for res in worlds["llama2-7b", n]:
            knob = res["knob"]
            np.testing.assert_array_equal(knob["tokens"], want)
            assert knob["has_mesh"] and knob["mesh_shape"] == shape
            for dep in ("fused", "disaggregated"):
                assert "deployment='sharded'" in knob[dep], knob[dep]
            assert "item 8" in knob["async"]

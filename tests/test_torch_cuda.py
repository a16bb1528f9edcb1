"""Tests of the port that need a CUDA card: the CUDA kernels against their
plain versions, the wrappers' refusals on card tensors, and the engine and
the paged scheduler on the card against the CPU. Without a card they skip.
This file imports nothing of JAX, so it also runs where only the port is
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.opsc import OPSCConfig
from repro_torch.core.payload import encode as payload_encode
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.kernels import tabq_quantize as tq
from repro_torch.kernels import ts_mask as tsm
from repro_torch.kernels import varlen_attention as va
from repro_torch.models import moe
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import init_params
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.split_engine import SplitEngine

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, b=2, kh=2, g=6, hd=64, s=600, seed=10):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, kh, g, hd)).astype(np.float32),
              rng.integers(-127, 128, (b, kh, s, hd)).astype(np.int8),
              rng.uniform(1e-3, 2e-2, (b, kh, s)).astype(np.float32),
              rng.integers(-127, 128, (b, kh, s, hd)).astype(np.int8),
              rng.uniform(1e-3, 2e-2, (b, kh, s)).astype(np.float32),
              np.tile(np.arange(s, dtype=np.int32), (b, 1)))
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_decode_attention_kernel_matches_plain_version(cuda_device, qdtype):
    """G = 6, S no multiple of any tile, per-row q_pos with a fully masked
    row; f32 math in another order, so 1e-4 absolute."""
    args = _inputs(cuda_device)
    args[0] = args[0].to(getattr(torch, qdtype))
    q_pos = torch.tensor([450, -1], dtype=torch.int32, device=cuda_device)
    before = da.decode_attention.launches
    got = ops.decode_attention(*args, q_pos)
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_ref(*args, q_pos)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)


def test_decode_attention_refuses_bad_card_input(cuda_device):
    args = _inputs(cuda_device, s=64)
    q_pos = torch.tensor(10, dtype=torch.int32, device=cuda_device)
    before = da.decode_attention.launches
    bad = [
        (args[:1] + [args[1].transpose(2, 3).contiguous().transpose(2, 3)]
         + args[2:], q_pos),  # non-contiguous codes
        (args, q_pos.to(torch.int64)),  # q_pos dtype
        (args, 10),  # a host int would sync the decode loop
        ([args[0][..., :48].contiguous()] + args[1:], q_pos),  # hd mismatch
    ]
    for a, qp in bad:
        with pytest.raises(ValueError):
            da.decode_attention(*a, qp)
    assert da.decode_attention.launches == before


def test_engine_on_card_matches_cpu(cuda_device):
    """llama2-7b tiny, same weights, int8 KV: greedy tokens on the card
    equal the CPU's, and every decode step launches the kernel once per
    layer."""
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    want = Engine(cfg, params, opts, cache_len=32,
                  device="cpu").generate(prompts, 6)
    before = da.decode_attention.launches
    got = Engine(cfg, params, opts, cache_len=32,
                 device=cuda_device).generate(prompts, 6)
    assert da.decode_attention.launches - before == cfg.num_layers * 5
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=1e-3,
                               atol=1e-3)


def _pool(rng, device, p=24, kh=2, page=16, hd=64, lens=(40, 0, 9)):
    """A pool holding ``lens[r]`` tokens for row r in pages taken in random
    order (page 0 is trash); a row of 0 tokens has an all-trash table."""
    order = rng.permutation(np.arange(1, p))
    nb = max(1, max(-(-n // page) for n in lens))
    bt = np.zeros((len(lens), nb), np.int32)
    pool_pos = np.full((p, page), -1, np.int32)
    nxt = 0
    for r, n in enumerate(lens):
        for b in range(-(-n // page)):
            bt[r, b] = order[nxt]
            nxt += 1
        for t in range(n):
            pool_pos[bt[r, t // page], t % page] = t
    arrays = (rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8),
              rng.uniform(1e-3, 2e-2, (p, kh, page)).astype(np.float32),
              rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8),
              rng.uniform(1e-3, 2e-2, (p, kh, page)).astype(np.float32),
              pool_pos, bt)
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_matches_plain_version(cuda_device, qdtype):
    """K2 with G = 3 and page 16; row 1 is a free slot (all-trash table,
    q_pos = -1) and gives exact zeros."""
    rng = np.random.default_rng(11)
    pool = _pool(rng, cuda_device)
    q = torch.from_numpy(rng.normal(size=(3, 2, 3, 64)).astype(
        np.float32)).to(cuda_device, getattr(torch, qdtype))
    q_pos = torch.tensor([39, -1, 8], dtype=torch.int32, device=cuda_device)
    before = pda.paged_decode_attention.launches
    got = ops.paged_decode_attention(q, *pool, q_pos)
    assert pda.paged_decode_attention.launches == before + 1
    want = pda.paged_decode_attention_ref(q, *pool, q_pos)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert (got[1] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,rows", [
    (64, [(33, 40), None, (0, 17)]),
    (128, [(150, 40), (0, 40), (70, 25)])])  # three 64-key history tiles
def test_paged_prefill_kernel_matches_plain_version(cuda_device, dtype, hd,
                                                    rows):
    """K3 with G = 2, S = 40 (no multiple of a tile): continuation rows, a
    fully padded row and rows with no history; pads give exact zeros. bf16
    takes the tensor cores, f32 the CUDA cores."""
    rng = np.random.default_rng(12)
    pool = _pool(rng, cuda_device, p=40, hd=hd,
                 lens=[0 if x is None else sum(x) for x in rows])
    s, dt = 40, getattr(torch, dtype)
    q_pos = np.full((3, s), -1, np.int32)
    for i, x in enumerate(rows):
        if x is not None:
            q_pos[i, s - x[1]:] = np.arange(x[0], x[0] + x[1])
    q_pos = torch.from_numpy(q_pos).to(cuda_device)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda_device, dt)

    q, kf, vf = rand(3, s, 2, 2, hd), rand(3, s, 2, hd), rand(3, s, 2, hd)
    before = ppa.paged_prefill_attention.launches
    routes = dict(ppa.paged_prefill_attention.route_launches)
    got = ops.paged_prefill_attention(q, *pool, q_pos, kf, vf)
    assert ppa.paged_prefill_attention.launches == before + 1
    way = "tensor_cores" if dtype == "bfloat16" else "cuda_cores"
    routes[way] += 1
    assert ppa.paged_prefill_attention.route_launches == routes
    start = ppa.first_call_position(q_pos)
    want = ppa.paged_prefill_attention_ref(q, *pool, q_pos, start, kf, vf)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert (got[q_pos < 0] == 0).all()


def test_paged_kernels_refuse_bad_card_input(cuda_device):
    rng = np.random.default_rng(13)
    kc, ks, vc, vs, pool_pos, bt = _pool(rng, cuda_device)
    q = torch.zeros((3, 2, 3, 64), device=cuda_device)
    q_pos = torch.tensor([39, -1, 8], dtype=torch.int32, device=cuda_device)
    before = pda.paged_decode_attention.launches
    for args in ((q, kc, ks, vc, vs, pool_pos, bt.cpu(), q_pos),
                 (q, kc, ks, vc, vs, pool_pos, bt, q_pos.cpu()),
                 (q, kc, ks, vc, vs, pool_pos.long(), bt, q_pos),
                 (q, kc[:, :, :3].contiguous(), ks, vc, vs, pool_pos, bt,
                  q_pos)):
        with pytest.raises(ValueError):
            pda.paged_decode_attention(*args)
    assert pda.paged_decode_attention.launches == before


def test_paged_scheduler_on_card_matches_cpu(cuda_device):
    """llama2-7b tiny through the Scheduler with chunked prefill and a
    shared prefix: the card's greedy tokens equal the CPU's, and K2 and K3
    run once per layer per decode step and per pool-attending chunk call."""
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (10,))
    prompts = [rng.integers(0, cfg.vocab_size, (18,))] + [
        np.concatenate([prefix, rng.integers(0, cfg.vocab_size, (n,))])
        for n in (3, 5)]

    def serve(device):
        sched = Scheduler(cfg, params, opts, num_pages=32, page_size=4,
                          max_slots=2, prefill_chunk=4, device=device)
        rids = [sched.submit(p, 6, prefix_key="sys" if i else None,
                             prefix_len=10 if i == 1 else None)
                for i, p in enumerate(prompts)]
        res = sched.run()
        return [res[r] for r in rids], sched.stats

    want, _ = serve("cpu")
    k2, k3 = (pda.paged_decode_attention.launches,
              ppa.paged_prefill_attention.launches)
    got, stats = serve(cuda_device)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert pda.paged_decode_attention.launches - k2 \
        == cfg.num_layers * stats.steps
    assert ppa.paged_prefill_attention.launches - k3 \
        == cfg.num_layers * stats.shared_prefill_calls > 0


def _varlen(rng, device, segs, pad, dtype, kh=2, g=2, hd=64, page=16,
            p=40):
    """K4's operands: slot i holds ``segs[i] = (history, fresh)`` tokens in
    its pages (of ``p``) and contributes ``fresh`` rows of the flat batch
    from position ``history``; ``pad`` pad rows close it."""
    pool = _pool(rng, device, p=p, kh=kh, page=page, hd=hd,
                 lens=[h + n for h, n in segs])
    t = sum(n for _, n in segs) + pad
    q_pos = np.full((t,), -1, np.int32)
    tok_slot = np.full((t,), -1, np.int32)
    cur = 0
    for i, (h, n) in enumerate(segs):
        q_pos[cur:cur + n] = np.arange(h, h + n)
        tok_slot[cur:cur + n] = i
        cur += n

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device, dtype)

    return (rand(kh, t, g, hd), *pool, torch.from_numpy(q_pos).to(device),
            torch.from_numpy(tok_slot).to(device), rand(kh, t, hd),
            rand(kh, t, hd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("segs,pad", [
    ([(90, 1), (57, 40), (0, 70), (7, 1)], 5),  # decode rows and chunks
    ([(5, 1), (30, 1), (0, 0), (64, 1)], 3),  # pure decode, a slot absent
    ([(3, 0), (4, 0)], 6),  # an all-pad buffer
])
def test_varlen_kernel_matches_plain_version(cuda_device, dtype, segs, pad):
    """K4 (through ``kernels.ops``) against its plain version at 1e-4, G =
    2, page 16; pad rows give exact zeros."""
    rng = np.random.default_rng(14)
    args = _varlen(rng, cuda_device, segs, pad, getattr(torch, dtype))
    start = ops.segment_start(args[7], args[8], len(segs))
    before = va.varlen_attention.launches
    got = ops.varlen_attention(*args[:9], start, *args[9:])
    assert va.varlen_attention.launches == before + 1
    want = va.varlen_attention_ref(*args[:9], start, *args[9:])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert (got[:, args[8] < 0] == 0).all()


@pytest.mark.parametrize("hd", [32, 256])
def test_varlen_tensor_core_route_at_the_edge_head_dims(cuda_device, hd):
    """K4's bf16 route at hd 32 (history splits of 256 keys) and 256 (key
    tiles of 32, splits of 128): a decode row over several splits,
    a continuation chunk and a first chunk agree with the plain version;
    pads are exact zeros."""
    rng = np.random.default_rng(19)
    segs = [(300, 1), (40, 33), (0, 20)]
    args = _varlen(rng, cuda_device, segs, 2, torch.bfloat16, hd=hd)
    start = va.segment_start(args[7], args[8], len(segs))
    routes = dict(va.varlen_attention.route_launches)
    got = va.varlen_attention(*args[:9], start, *args[9:])
    routes["tensor_cores"] += 1
    want = va.varlen_attention_ref(*args[:9], start, *args[9:])
    torch.cuda.synchronize()
    assert va.varlen_attention.route_launches == routes
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert (got[:, args[8] < 0] == 0).all()


def test_varlen_kernel_takes_the_routes_and_reads_a_given_work_list(
        cuda_device):
    """bf16 q takes the tensor-core route, f32 the CUDA cores; a work list
    built once (as ``layers.packed_layout`` does) gives the bits of one
    built in the call, and segments split into several runs of the buffer
    agree with the plain version."""
    rng = np.random.default_rng(18)
    segs = [(300, 1), (57, 40), (0, 70), (600, 1)]
    args = list(_varlen(rng, cuda_device, segs, 3, torch.bfloat16, hd=128,
                        page=16, p=80))
    sl = args[8]
    # interleave the 40-row and 70-row segments' rows two at a time
    idx = torch.arange(sl.numel(), device=cuda_device)
    a, b = idx[sl == 1], idx[sl == 2]
    mixed = torch.cat([torch.stack([a[:40:2], a[1:40:2], b[:40:2],
                                    b[1:40:2]], 1).reshape(-1), b[40:]])
    perm = torch.cat([idx[sl == 0], mixed, idx[sl == 3], idx[sl < 0]])
    for i in (0, 9, 10):
        args[i] = args[i][:, perm].contiguous()
    args[7], args[8] = args[7][perm], args[8][perm]
    start = va.segment_start(args[7], args[8], len(segs))
    rows = va.segment_rows(args[8], len(segs))
    routes = dict(va.varlen_attention.route_launches)
    got = va.varlen_attention(*args[:9], start, *args[9:])
    got_rows = va.varlen_attention(*args[:9], start, *args[9:], rows)
    routes["tensor_cores"] += 2
    want = va.varlen_attention_ref(*args[:9], start, *args[9:])
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    va.varlen_attention(*f32[:9], start, *f32[9:])
    routes["cuda_cores"] += 1
    torch.cuda.synchronize()
    assert va.varlen_attention.route_launches == routes
    assert torch.equal(got, got_rows)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert (got[:, args[8] < 0] == 0).all()


def test_kernels_launch_on_two_cards_in_one_process(cuda_device):
    """K3, K4 and K7 on each of two cards in one process, every route
    that opts in to more than 48 KB of shared memory: the opt-in is made
    on each device (it acts on the current one), so the second card's
    launches run and agree with the plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the opt-in to more shared "
                    "memory is made per device")
    for index in (0, 1):
        dev = torch.device("cuda", index)
        rng = np.random.default_rng(30 + index)
        for dtype in (torch.float32, torch.bfloat16):
            args = _varlen(rng, dev, [(90, 1), (57, 40), (0, 70)], 3, dtype,
                           hd=128)
            start = va.segment_start(args[7], args[8], 3)
            got = va.varlen_attention(*args[:9], start, *args[9:])
            want = va.varlen_attention_ref(*args[:9], start, *args[9:])
            torch.cuda.synchronize(dev)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=0, atol=1e-4)
            pool = _pool(rng, dev, p=40, hd=128, lens=[190, 40])
            q_pos = torch.full((2, 64), -1, dtype=torch.int32, device=dev)
            q_pos[0, :40] = torch.arange(150, 190)
            q_pos[1] = torch.arange(-24, 40).clamp_min(-1)
            q = torch.randn((2, 64, 2, 1, 128), device=dev).to(dtype)
            kf = torch.randn((2, 64, 2, 128), device=dev).to(dtype)
            vf = torch.randn((2, 64, 2, 128), device=dev).to(dtype)
            got = ops.paged_prefill_attention(q, *pool, q_pos, kf, vf)
            want = ppa.paged_prefill_attention_ref(
                q, *pool, q_pos, ppa.first_call_position(q_pos), kf, vf)
            torch.cuda.synchronize(dev)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=0, atol=1e-4)
        codes = torch.randint(-127, 128, (4096, 4096), dtype=torch.int8,
                              device=dev)
        scale = torch.rand((4096,), device=dev) * 0.01 + 1e-4
        for m in (128, 384):  # tc_gemm_kernel and the large-M kernel
            x = torch.randn((m, 4096), device=dev).to(torch.bfloat16)
            got = dm.dequant_matmul(x, codes, scale)
            want = dm.dequant_matmul_ref(x, codes, scale)
            bound = (x.float().abs() @ codes.float().abs() * scale).max()
            torch.cuda.synchronize(dev)
            assert float((got - want).abs().max()) <= 1e-5 * float(bound)


def test_varlen_kernel_reads_transposed_views(cuda_device):
    """The model hands K4 (K, T, ...) views of its (T, K, ...) tensors: the
    result equals the kernel's on contiguous copies, laid out as q is."""
    rng = np.random.default_rng(15)
    args = list(_varlen(rng, cuda_device, [(20, 3), (0, 9)], 4,
                        torch.float32))
    start = va.segment_start(args[7], args[8], 2)
    want = va.varlen_attention(*args[:9], start, *args[9:])
    for i in (0, 9, 10):
        args[i] = args[i].transpose(0, 1).contiguous().transpose(0, 1)
    got = va.varlen_attention(*args[:9], start, *args[9:])
    assert got.stride() == args[0].stride()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_packed_scheduler_on_card_matches_cpu(cuda_device):
    """llama2-7b tiny through the packed Scheduler with lazy growth and
    swap preemption: the card's greedy tokens equal the CPU's, and K4 runs
    once per layer per packed tick (K2 and K3 never)."""
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 24)]

    def serve(device):
        sched = Scheduler(cfg, params, opts, num_pages=10, page_size=4,
                          max_slots=2, prefill_chunk=4, lazy_growth=True,
                          tick_mode="packed", device=device)
        rids = [sched.submit(p, n, priority=pr)
                for p, n, pr in zip(prompts, (10, 3), (1, 0))]
        res = sched.run()
        return [res[r] for r in rids], sched.stats

    want, _ = serve("cpu")
    k2, k3, k4 = (pda.paged_decode_attention.launches,
                  ppa.paged_prefill_attention.launches,
                  va.varlen_attention.launches)
    got, stats = serve(cuda_device)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats.preemptions >= 1
    assert va.varlen_attention.launches - k4 \
        == cfg.num_layers * stats.packed_ticks
    assert (pda.paged_decode_attention.launches,
            ppa.paged_prefill_attention.launches) == (k2, k3)


def test_varlen_kernel_rows_do_not_depend_on_placement(cuda_device):
    """The same tokens laid out in another slot order give bit-identical
    rows: which fresh keys share a tile depends on the segment alone."""
    rng = np.random.default_rng(16)
    segs = [(90, 1), (57, 40), (0, 70), (7, 1)]
    args = list(_varlen(rng, cuda_device, segs, 3, torch.float32))
    sl = args[8]
    perm = torch.cat([torch.nonzero(sl == i)[:, 0] for i in (2, 0, 3, 1)]
                     + [torch.nonzero(sl < 0)[:, 0]])
    moved = list(args)
    for i in (0, 9, 10):
        moved[i] = args[i][:, perm].contiguous()
    moved[7], moved[8] = args[7][perm], args[8][perm]
    start = ops.segment_start(args[7], args[8], len(segs))
    got = ops.varlen_attention(*args[:9], start, *args[9:])
    got_moved = ops.varlen_attention(*moved[:9], start, *moved[9:])
    torch.cuda.synchronize()
    assert torch.equal(got_moved, got[:, perm])


def _activations(rng, t, d, dtype, outliers=0):
    """bf16-rounded activations (ties in magnitude), a few outliers."""
    x = (rng.normal(size=(t, d)) * 2.0).astype(np.float32)
    if outliers:
        x.reshape(-1)[rng.choice(t * d, outliers, replace=False)] *= 30.0
    return torch.from_numpy(x).to(torch.bfloat16).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(1, 4096), (7, 64), (128, 4096), (3, 100)])
def test_tabq_and_ts_kernels_equal_plain_versions(cuda_device, dtype, t, d):
    """K5 at every bit width and K6 are bit-identical to their plain
    versions: codes, scales, zeros, signs; below, the carrier and the
    count, at the codec's default capacity; one K6 launch a call."""
    rng = np.random.default_rng(t + d)
    x = _activations(rng, t, d, getattr(torch, dtype), outliers=t).to(
        cuda_device)
    x[0, :4] = 0.0
    for bits in range(1, 9):
        before = tq.tabq_quantize.launches
        got = ops.tabq_quantize(x, bits)
        assert tq.tabq_quantize.launches == before + 1
        want = tq.tabq_quantize_ref(x, bits)
        for g, w in zip(got, want):
            assert torch.equal(g, w), bits
    cap = max(16, t * d // 1024)
    for tau in (0.5, 5.0, 1e3):
        before = tsm.ts_encode.launches
        got = ops.ts_encode(x, tau, cap)
        assert tsm.ts_encode.launches == before + 1
        assert _same_bits(got, tsm.ts_encode_ref(x, tau, cap)), tau


def _same_bits(got, want) -> bool:
    """Equal dtypes, shapes and bits (a NaN equals itself)."""
    def bits(a):
        return a.view(torch.int32) if a.dtype == torch.float32 else a
    return all(g.dtype == w.dtype and g.shape == w.shape
               and torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def test_payload_on_card_equals_cpu(cuda_device):
    """The codec through K5 (TAB-Q's walk in one launch) and K6 on the
    card equals the plain versions on the CPU, with more entries above τ
    than the carrier holds."""
    rng = np.random.default_rng(3)
    x = _activations(rng, 16, 1024, torch.float32, outliers=60)
    before = (tq.tabq_adaptive.launches, tq.tabq_quantize.launches)
    got = payload_encode(x.to(cuda_device), tau=5.0)
    # TAB-Q's walk: one launch, no per-level launch
    assert (tq.tabq_adaptive.launches, tq.tabq_quantize.launches) == (
        before[0] + 1, before[1])
    want = payload_encode(x, tau=5.0)
    assert int(want.above.count) > want.above.values.shape[0]
    for name in ("codes", "sign", "scale", "zero", "bits"):
        assert torch.equal(getattr(got.below, name).cpu(),
                           getattr(want.below, name)), name
    assert torch.equal(got.above.indices.cpu(), want.above.indices)
    assert torch.equal(got.above.values.cpu(), want.above.values)
    assert got.payload_bits() == want.payload_bits()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (1, 11008, 4096),
                                   (4, 4096, 11008), (3, 100, 17),
                                   (128, 11008, 4096), (70, 130, 50),
                                   (128, 4096, 11008), (96, 4096, 4096),
                                   (70, 200, 80), (384, 4096, 11008),
                                   (600, 11008, 4096), (300, 1000, 48)])
def test_dequant_matmul_kernel_matches_plain_version(cuda_device, dtype, m,
                                                     k, n):
    """K7 (split-K GEMV for M <= 4; above, the tensor cores for bf16 x
    with N % 16 == 0 and K % 8 == 0, from ``LARGE_M_MIN`` rows the large-M
    kernel, the CUDA cores otherwise) against its plain version: f32 sums
    in another order, so within 1e-5 of the largest possible term sum
    |x| @ |codes| * scale."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda_device, getattr(torch, dtype))
    codes = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(
        np.int8)).to(cuda_device)
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-1, (n,)).astype(
        np.float32)).to(cuda_device)
    before = dm.dequant_matmul.launches
    routes = dict(dm.dequant_matmul.route_launches)
    got = ops.dequant_matmul(x, codes, scale)
    assert dm.dequant_matmul.launches == before + 1
    way = "gemv" if m <= 4 else "cuda_cores" if (
        dtype == "float32" or n % 16 or k % 8) else "tensor_cores_large_m" \
        if m >= dm.LARGE_M_MIN else "tensor_cores"
    routes[way] += 1
    assert dm.dequant_matmul.route_launches == routes
    want = dm.dequant_matmul_ref(x, codes, scale)
    bound = (x.float().abs() @ codes.float().abs() * scale).max()
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(bound)


def test_split_kernels_refuse_bad_card_input(cuda_device):
    x = torch.zeros((2, 64), device=cuda_device)
    codes = torch.zeros((64, 8), dtype=torch.int8, device=cuda_device)
    scale = torch.ones(8, device=cuda_device)
    counts = (tq.tabq_quantize.launches, tsm.ts_encode.launches,
              dm.dequant_matmul.launches)
    for bad in (x.double(), x.t(), x[None]):
        with pytest.raises(ValueError):
            tq.tabq_quantize(bad, 4)
        with pytest.raises(ValueError):
            tsm.ts_encode(bad, 1.0, 16)
    with pytest.raises(ValueError):
        tq.tabq_quantize(x, 9)
    for args in ((x, codes.float(), scale), (x, codes[:32], scale),
                 (x, codes, scale[:4]), (x, codes.t().contiguous().t(),
                                         scale), (x, codes, scale.cpu())):
        with pytest.raises(ValueError):
            dm.dequant_matmul(*args)
    assert (tq.tabq_quantize.launches, tsm.ts_encode.launches,
            dm.dequant_matmul.launches) == counts


def test_split_engine_on_card_matches_cpu(cuda_device):
    """llama2-7b tiny through the split engine (int4-code front, TS +
    TAB-Q payload, int8 KV): the card's tokens equal the CPU's, and the
    run launches K5 (TAB-Q's walk, once a payload), K6 and K7."""
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    opsc = OPSCConfig(split_layer=1, qw_front=4, tau=0.5)
    want, wst = SplitEngine(cfg, params, opsc, opts=opts, cache_len=32,
                            device="cpu").generate(prompts, 6)
    before = (tq.tabq_adaptive.launches, tsm.ts_encode.launches,
              dm.dequant_matmul.launches, tq.tabq_quantize.launches)
    got, gst = SplitEngine(cfg, params, opsc, opts=opts, cache_len=32,
                           device=cuda_device).generate(prompts, 6)
    after = (tq.tabq_adaptive.launches, tsm.ts_encode.launches,
             dm.dequant_matmul.launches, tq.tabq_quantize.launches)
    np.testing.assert_array_equal(got, want)
    assert gst.uplink_bits_measured == wst.uplink_bits_measured
    assert after[0] - before[0] == 6  # TAB-Q's walk: one launch a payload
    assert after[1] - before[1] == 6
    assert after[2] - before[2] == 7 * 6  # seven products, six edge calls
    assert after[3] == before[3]  # no per-level launch


# ------------------------------------------- K2 split over blocks, GEMV


# K2's shapes that reach several splits (chip_smoke.py's): the serve tick,
# a row filling its whole table, hd 256 (128-key splits), G 6, and a row
# whose first split holds only masked keys
K2_SPLIT_SHAPES = {
    # name: (K, G, hd, page, nb, tokens per row, masked positions of row 0)
    "serve": (32, 1, 128, 16, 64, [1024, 700, 301, 64, 17, 1, 0, 500], 0),
    "full_table": (4, 1, 128, 16, 64, [1024, 3], 0),
    "hd256": (4, 2, 256, 16, 40, [640, 130], 0),
    "g6": (2, 6, 128, 16, 48, [700, 20], 0),
    "first_split_masked": (2, 1, 128, 16, 48, [700, 300], 300),
}


def _split_pool(rng, device, kh, hd, page, nb, tokens, masked=0):
    """A pool holding ``tokens[r]`` tokens for row r in pages taken in
    random order (page 0 is trash), row 0's positions below ``masked``
    left empty; and its (R, nb) block table."""
    need = [-(-n // page) for n in tokens]
    p = 1 + sum(need) + 3
    order = rng.permutation(np.arange(1, p))
    bt = np.zeros((len(tokens), nb), np.int32)
    pool_pos = np.full((p, page), -1, np.int32)
    nxt = 0
    for r, n in enumerate(tokens):
        for b in range(need[r]):
            bt[r, b] = order[nxt]
            nxt += 1
        for t in range(masked if r == 0 else 0, n):
            pool_pos[bt[r, t // page], t % page] = t
    arrays = (rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8),
              rng.uniform(1e-3, 2e-2, (p, kh, page)).astype(np.float32),
              rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8),
              rng.uniform(1e-3, 2e-2, (p, kh, page)).astype(np.float32),
              pool_pos, bt)
    return [torch.from_numpy(a).to(device) for a in arrays]


def _k2_split_case(device, name, qdtype, seed=17):
    kh, g, hd, page, nb, toks, masked = K2_SPLIT_SHAPES[name]
    rng = np.random.default_rng(seed)
    pool = _split_pool(rng, device, kh, hd, page, nb, toks, masked)
    q = torch.from_numpy(rng.normal(size=(len(toks), kh, g, hd)).astype(
        np.float32)).to(device, qdtype)
    q_pos = torch.tensor([n - 1 for n in toks], dtype=torch.int32,
                         device=device)
    return q, pool, q_pos, toks


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(K2_SPLIT_SHAPES))
def test_paged_decode_split_kernel_matches_plain_version_and_repeats(
        cuda_device, qdtype, name):
    """K2 with rows over several splits: within 1e-4 of its plain version
    (f32 math in another order), free rows exact zeros, one call counted,
    and two calls bit-identical (the splits merge in a fixed order)."""
    q, pool, q_pos, toks = _k2_split_case(cuda_device, name,
                                          getattr(torch, qdtype))
    before = pda.paged_decode_attention.launches
    got = pda.paged_decode_attention(q, *pool, q_pos)
    again = pda.paged_decode_attention(q, *pool, q_pos)
    assert pda.paged_decode_attention.launches == before + 2
    want = pda.paged_decode_attention_ref(q, *pool, q_pos)
    torch.cuda.synchronize()
    assert pda.splits(pool[5].shape[1], pool[0].shape[2],
                      pda.SPLIT[q.shape[-1]]) > 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert torch.equal(got, again)
    for i, n in enumerate(toks):
        if n == 0:
            assert (got[i] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (1, 4096, 11008),
                                   (1, 11008, 4096), (4, 4096, 11008),
                                   (2, 4096, 528), (3, 200, 80)])
def test_gemv_kernel_matches_plain_version_and_repeats(cuda_device, dtype,
                                                       m, k, n):
    """The 16-byte GEMV (N % 16 == 0, aligned bases) at llama2-7b's decode
    products and ragged column tiles: within 1e-5 of |x| @ |codes| * scale
    of its plain version, and two calls bit-identical (the K ranges are
    added in a fixed order; the tickets are back at zero after a call)."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda_device, getattr(torch, dtype))
    codes = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(
        np.int8)).to(cuda_device)
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-1, (n,)).astype(
        np.float32)).to(cuda_device)
    assert dm.gemv_vec(n, codes.data_ptr(), scale.data_ptr()) == 16
    got = dm.dequant_matmul(x, codes, scale)
    again = dm.dequant_matmul(x, codes, scale)
    want = dm.dequant_matmul_ref(x, codes, scale)
    bound = (x.float().abs() @ codes.float().abs() * scale).max()
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(bound)
    assert torch.equal(got, again)


def test_paged_decode_and_gemv_replay_from_a_cuda_graph(cuda_device):
    """One K2 call at the serve shape and one GEMV at w_up, captured in a
    CUDA graph: each replay equals the eager call bit for bit (grids from
    shapes alone, no host read-back, the GEMV's tickets reset in the
    kernel)."""
    q, pool, q_pos, _ = _k2_split_case(cuda_device, "serve", torch.bfloat16)
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.normal(size=(1, 4096)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    codes = torch.from_numpy(rng.integers(-7, 8, (4096, 11008)).astype(
        np.int8)).to(cuda_device)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, (11008,)).astype(
        np.float32)).to(cuda_device)
    for fn in (lambda: pda.paged_decode_attention(q, *pool, q_pos),
               lambda: dm.dequant_matmul(x, codes, scale)):
        eager = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_paged_decode_routes_agree_at_the_decode_tick(cuda_device, qdtype):
    """At the paged decode tick's shape (8 rows of 129 tokens through a
    64-page table: one split a row) the route takes the split kernel, which
    walks each row in one pass, and the single-pass kernel takes the same
    call: each within 1e-4 of the plain version, each repeating its bits,
    and the wrapper counts the call on its route."""
    rng = np.random.default_rng(19)
    toks = [129] * 8
    pool = _split_pool(rng, cuda_device, 32, 128, 16, 64, toks)
    q = torch.from_numpy(rng.normal(size=(8, 32, 1, 128)).astype(
        np.float32)).to(cuda_device, getattr(torch, qdtype))
    q_pos = torch.full((8,), 128, dtype=torch.int32, device=cuda_device)
    assert pda.route(128, 16, 64) == "split"
    want = pda.paged_decode_attention_ref(q, *pool, q_pos)
    for way in pda.ROUTES:
        got = pda.launch_route(way, q, *pool, q_pos)
        again = pda.launch_route(way, q, *pool, q_pos)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=1e-4)
        assert torch.equal(got, again)
    before = dict(pda.paged_decode_attention.route_launches)
    pda.paged_decode_attention(q, *pool, q_pos)
    after = pda.paged_decode_attention.route_launches
    assert after["split"] == before["split"] + 1
    assert after["single_pass"] == before["single_pass"]


def test_captured_calls_keep_their_tickets_when_an_eager_call_grows(
        cuda_device):
    """Two K2 calls over several splits, captured in CUDA graphs, each get
    ticket buffers of their own: an eager call that outgrows the stream's
    buffer (40 rows x 32 kv-heads = 1,280 tickets) leaves both graphs'
    replays bit-identical to their eager calls, also replayed side by side
    on two streams."""
    calls = []
    for name in ("full_table", "g6"):
        q, pool, q_pos, _ = _k2_split_case(cuda_device, name,
                                           torch.bfloat16)
        calls.append(lambda q=q, pool=pool, q_pos=q_pos:
                     pda.paged_decode_attention(q, *pool, q_pos))
    eager = [fn() for fn in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    for fn in calls:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(fn())
        graphs.append(graph)
    # an eager call with more (row, kv-head) tickets than the buffer holds
    rng = np.random.default_rng(20)
    toks = [300] * 40
    pool = _split_pool(rng, cuda_device, 32, 32, 16, 20, toks)
    q = torch.from_numpy(rng.normal(size=(40, 32, 1, 32)).astype(
        np.float32)).to(cuda_device)
    q_pos = torch.full((40,), 299, dtype=torch.int32, device=cuda_device)
    big = pda.paged_decode_attention(q, *pool, q_pos)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        big.cpu().numpy(),
        pda.paged_decode_attention_ref(q, *pool, q_pos).cpu().numpy(),
        rtol=0, atol=1e-4)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(3):
        for graph, st in zip(graphs, streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, eager):
            assert torch.equal(out, want)


# K1's check shapes (chip_smoke.py's): (B, K, G, hd, S, live slots, per-row
# q_pos or None, a row whose slots are all empty)
K1_SHAPES = {
    "main": (4, 32, 1, 128, 1024, 1024, None, None),
    "split_step": (1, 32, 1, 128, 1024, 160, None, None),
    "serve_step": (2, 32, 1, 128, 1024, 192, None, None),
    "long_cache": (4, 32, 1, 128, 4096, 200, None, None),
    "tiny": (2, 2, 2, 32, 96, 50, None, None),
    "g6": (2, 2, 6, 64, 600, 450, None, None),
    "masked_row": (2, 2, 2, 32, 96, 96, [40, -1], None),
    "mqa_48": (1, 1, 48, 128, 700, 700, None, None),
    "hd256": (2, 4, 3, 256, 130, 100, None, None),
    "empty_live_row": (2, 4, 1, 128, 512, 512, [300, 511], 0),
    # qwen3-moe-235b-a22b's decode step: 64 heads on 4 kv heads
    "qwen3_g16": (2, 4, 16, 128, 1024, 1024, None, None),
    # internlm2-20b's (48 heads on 8) and granite-34b's (48 on 1) steps
    "internlm2_g6": (2, 8, 6, 128, 1024, 700, None, None),
    "granite_g48": (2, 1, 48, 128, 1024, 700, None, None),
    # qwen2-vl-2b's decode step (12 heads on 2; 1,024 patch slots and 128
    # text tokens, 16 new: cache_len 1,168 padded to 1,536) and
    # musicgen-medium's (24 heads on 24 at head dim 64; 512 + 32 tokens)
    "qwen2vl_g6": (2, 2, 6, 128, 1536, 1167, None, None),
    "musicgen_hd64": (2, 24, 1, 64, 1024, 543, None, None),
}


def _k1_case(device, name, qdtype, seed=21):
    b, kh, g, hd, s, live, qp, empty = K1_SHAPES[name]
    args = _inputs(device, b, kh, g, hd, s, seed)
    args[0] = args[0].to(qdtype)
    args[5] = torch.where(args[5] < live, args[5], -1).contiguous()
    if empty is not None:
        args[5][empty] = -1
    q_pos = torch.tensor(live - 1 if qp is None else qp, dtype=torch.int32,
                         device=device)
    return args, q_pos


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(K1_SHAPES))
def test_decode_attention_matches_plain_version_and_repeats(
        cuda_device, qdtype, name):
    """K1 within 1e-4 of the plain version (f32 math in another order; a
    row with no valid slot the uniform average of v), each call repeated
    bit for bit (the units merge in a fixed order; the tickets are back at
    zero) and counted once."""
    args, q_pos = _k1_case(cuda_device, name, getattr(torch, qdtype))
    want = da.decode_attention_ref(*args, q_pos)
    before = da.decode_attention.launches
    got = da.decode_attention(*args, q_pos)
    again = da.decode_attention(*args, q_pos)
    assert da.decode_attention.launches == before + 2
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert torch.equal(got, again)


def test_decode_attention_replays_from_a_cuda_graph(cuda_device):
    """K1 at the serve step's shape (several units a row, tickets) and at
    the main shape, captured in CUDA graphs: each replay equals the eager
    call bit for bit, also after an eager call has outgrown the stream's
    ticket buffer (40 rows x 32 kv-heads = 1,280 tickets) and with the two
    graphs replayed side by side on two streams."""
    calls = []
    for name in ("serve_step", "main"):
        args, q_pos = _k1_case(cuda_device, name, torch.bfloat16)
        calls.append(lambda args=args, q_pos=q_pos:
                     da.decode_attention(*args, q_pos))
    eager = [fn() for fn in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    for fn in calls:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(fn())
        graphs.append(graph)
    big = _inputs(cuda_device, b=40, kh=32, g=1, hd=32, s=300, seed=22)
    q_pos = torch.tensor(299, dtype=torch.int32, device=cuda_device)
    got = da.decode_attention(*big, q_pos)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        got.cpu().numpy(),
        da.decode_attention_ref(*big, q_pos).cpu().numpy(), rtol=0,
        atol=1e-4)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(3):
        for graph, st in zip(graphs, streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, eager):
            assert torch.equal(out, want)


# K1 over a sliding-window ring that has wrapped: (B, K, G, hd, S slots, W
# ring slots, q_pos). Slot t < W holds the position p = t (mod W) in
# (q_pos - W, q_pos]; slots W .. S - 1 (block padding) hold -1
K1_RINGS = {
    "danube_step": (2, 8, 4, 120, 4096, 4096, 4223),
    "padded_ring": (2, 2, 4, 120, 1024, 600, 1000),
    # odd S: units start at odd slot indices (8-byte staging at hd 120)
    "odd_slots": (2, 2, 4, 120, 301, 301, 450),
    "tiny_ring": (2, 2, 2, 32, 16, 16, 47),
}


def ring_positions(b, s, w, q_pos):
    """(B, S) int32 positions of a wrapped ring (``K1_RINGS``)."""
    t = np.arange(s)
    p = q_pos - ((q_pos - t) % w)
    return np.tile(np.where(t < w, p, -1).astype(np.int32), (b, 1))


def _k1_ring(device, name, qdtype, seed=23):
    b, kh, g, hd, s, w, qp = K1_RINGS[name]
    args = _inputs(device, b, kh, g, hd, s, seed)
    args[0] = args[0].to(qdtype)
    args[5] = torch.from_numpy(ring_positions(b, s, w, qp)).to(device)
    return args, torch.tensor(qp, dtype=torch.int32, device=device)


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(K1_RINGS))
def test_decode_attention_over_a_wrapped_ring_matches_plain_version(
        cuda_device, qdtype, name):
    """K1 over a ring that has wrapped (hd 120 at h2o-danube-3-4b's decode
    shape, a padded ring, an odd slot count) within 1e-4 of the plain
    version, which masks by position over all S slots; each call repeated
    bit for bit."""
    args, q_pos = _k1_ring(cuda_device, name, getattr(torch, qdtype))
    want = da.decode_attention_ref(*args, q_pos)
    before = da.decode_attention.launches
    got = da.decode_attention(*args, q_pos)
    again = da.decode_attention(*args, q_pos)
    assert da.decode_attention.launches == before + 2
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert torch.equal(got, again)


def test_decode_attention_over_a_ring_replays_from_a_cuda_graph(cuda_device):
    """K1 at h2o-danube-3-4b's decode shape over a wrapped ring (two units
    a row, tickets) captured in a CUDA graph: each replay equals the eager
    call bit for bit."""
    args, q_pos = _k1_ring(cuda_device, "danube_step", torch.bfloat16)
    eager = da.decode_attention(*args, q_pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(*args, q_pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(*args, q_pos)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.parametrize("name", ["gemma2-2b-tiny", "h2o-danube-3-4b-tiny"])
def test_sliding_window_families_engine_on_card_matches_cpu(cuda_device,
                                                            name):
    """The two sliding-window families, tiny, same f32 weights, int8 KV, a
    20-token prompt past the 16-slot window and 8 new tokens (the rings
    wrap in prefill and keep wrapping): greedy tokens on the card equal the
    CPU's; h2o-danube launches K1 once a layer and decode step, gemma2
    never (its soft cap takes the plain route)."""
    cfg = get_config(name)
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20))
    want = Engine(cfg, params, opts, cache_len=32,
                  device="cpu").generate(prompts, 8)
    before = da.decode_attention.launches
    got = Engine(cfg, params, opts, cache_len=32,
                 device=cuda_device).generate(prompts, 8)
    windowed_only = cfg.pattern[0].mixer.attn_softcap is None
    assert da.decode_attention.launches - before == (
        cfg.num_layers * 7 if windowed_only else 0)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(1, 4096), (7, 64), (96, 4096),
                                 (128, 4096), (3, 100)])
def test_tabq_adaptive_equals_plain_version_and_per_level_loop(
        cuda_device, dtype, t, d):
    """TAB-Q's walk in one launch is bit-identical to its plain version on
    the card and to the per-level loop over K5's kernel (codes, sign,
    scale, zero, bits) for every max_bits and Δ 0.05, 0.2 and 1.0, with a
    token of zeros and one of equal magnitudes; one launch a call."""
    rng = np.random.default_rng(t + d + 1)
    x = _activations(rng, t, d, getattr(torch, dtype), outliers=t).to(
        cuda_device)
    x[0, :4] = 0.0
    if t > 2:
        x[1] = torch.where(x[1] < 0, -1.5, 1.5).to(x.dtype)
        x[2] = 0.0
    for max_bits in range(2, 9):
        for delta in (0.05, 0.2, 1.0):
            before = tq.tabq_adaptive.launches
            got = ops.tabq_adaptive(x, max_bits, delta)
            assert tq.tabq_adaptive.launches == before + 1
            plain = tq.tabq_adaptive_ref(x, max_bits, delta)
            loop = tq.tabq_adaptive_ref(x, max_bits, delta,
                                        level=tq.tabq_quantize)
            for name, g, p, lp in zip(("codes", "sign", "scale", "zero",
                                       "bits"), got, plain, loop):
                assert torch.equal(g, p), (name, max_bits, delta)
                assert torch.equal(g, lp), (name, max_bits, delta)


def test_tabq_adaptive_repeats_and_replays_from_a_cuda_graph(cuda_device):
    """The walk at the decode payload's shape: two calls bit-identical,
    and a replay of a captured call equal to the eager call."""
    rng = np.random.default_rng(23)
    x = _activations(rng, 1, 4096, torch.float32, outliers=3).to(
        cuda_device)
    eager = tq.tabq_adaptive(x, 8, 0.2)
    assert all(torch.equal(a, b)
               for a, b in zip(eager, tq.tabq_adaptive(x, 8, 0.2)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tq.tabq_adaptive(x, 8, 0.2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tq.tabq_adaptive(x, 8, 0.2)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))


def test_tabq_adaptive_refuses_bad_card_input(cuda_device):
    x = torch.zeros((2, 64), device=cuda_device)
    before = tq.tabq_adaptive.launches
    for bad, mb in ((x, 1), (x, 9), (x.double(), 8), (x.t(), 8),
                    (x[None], 8),
                    (torch.zeros((1, tq.MAX_ADAPTIVE_D + 1),
                                 device=cuda_device), 8)):
        with pytest.raises(ValueError):
            tq.tabq_adaptive(bad, mb, 0.2)
    assert tq.tabq_adaptive.launches == before


# ------------------------------------------- K6: threshold split's encode


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _ts_input(name):
    """(x (T, D) f32, tau, capacity): the grid of
    ``tests/test_torch_ts_select.py``, bf16-origin as the split engine's
    payload, built without JAX."""
    rng = np.random.default_rng(len(name))

    def clipped(shape):
        return np.clip(_bf16(rng.normal(size=shape).astype(np.float32)),
                       -4.0, 4.0)

    def outliers(shape, m, nans=0):
        x = clipped(shape)
        flat = x.reshape(-1)
        at = rng.choice(flat.size, m + nans, replace=False)
        flat[at[:m]] = rng.uniform(6.0, 60.0, m) * rng.choice([-1, 1], m)
        flat[at[m:]] = np.nan
        return x

    def ties(shape):  # 40 of |x| = 7 over every tile; the C-th is a 7
        x = clipped(shape)
        flat = x.reshape(-1)
        at = rng.choice(flat.size, 46, replace=False)
        flat[at[:40]] = 7.0 * rng.choice([-1, 1], 40)
        flat[at[40:]] = [9.0, -11.0, 9.0, 30.0, -9.0, 12.0]
        return x

    normal = {"count_0": ((1, 4096), 1e3, 16), "count_far_above_C":
              ((7, 100), 0.5, 16), "everything_above": ((7, 100), 0.0, 100),
              "t1_payload": ((1, 4096), 5.0, 16),
              "t128_payload": ((128, 4096), 5.0, 512),
              "t600_overflow": ((600, 4096), 0.5, 2400)}
    if name in normal:
        shape, tau, cap = normal[name]
        return _bf16((rng.normal(size=shape) * 2.0).astype(np.float32)), \
            tau, cap
    return {"count_below_C": lambda: (outliers((1, 4096), 5), 5.0, 16),
            "count_equals_C": lambda: (outliers((1, 4096), 16), 5.0, 16),
            "ties_across_tiles": lambda: (ties((3, 4096)), 5.0, 16),
            "ragged_d": lambda: (clipped((7, 100)) * 1.5, 2.0, 16),
            "t7_overflow": lambda: (outliers((7, 4096), 200), 5.0, 72),
            "nan": lambda: (outliers((2, 1000), 30, nans=3), 5.0, 16)}[
                name]()


TS_CASES = ("count_0", "count_below_C", "count_equals_C",
            "count_far_above_C", "ties_across_tiles", "everything_above",
            "ragged_d", "t1_payload", "t7_overflow", "nan", "t128_payload",
            "t600_overflow")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", TS_CASES)
def test_ts_encode_kernel_equals_plain_version_and_repeats(cuda_device,
                                                           name, dtype):
    """K6 is bit-identical to ``ts_encode_ref`` on the card (below, values,
    indices, count), twice in a row: its state is back at zero after a
    call. One launch a call."""
    x, tau, cap = _ts_input(name)
    x = torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
    want = tsm.ts_encode_ref(x, tau, cap)
    for _ in range(2):
        before = tsm.ts_encode.launches
        got = ops.ts_encode(x, tau, cap)
        assert tsm.ts_encode.launches == before + 1
        torch.cuda.synchronize()
        assert _same_bits(got, want)


def test_ts_encode_replays_from_a_cuda_graph(cuda_device):
    """Captured K6 calls (a decode and a 128-token payload) replay equal to
    their plain versions, also after an eager call has outgrown the
    stream's state and workspace, and on two streams side by side."""
    calls = []
    for name in ("t1_payload", "t128_payload"):
        x, tau, cap = _ts_input(name)
        x = torch.from_numpy(x).to(cuda_device)
        calls.append((lambda x=x, tau=tau, cap=cap: ops.ts_encode(x, tau,
                                                                  cap),
                      tsm.ts_encode_ref(x, tau, cap)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn, _ in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    for fn, _ in calls:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(fn())
        graphs.append(graph)
    x, tau, cap = _ts_input("t600_overflow")
    x = torch.from_numpy(x).to(cuda_device)
    assert _same_bits(ops.ts_encode(x, tau, cap),
                      tsm.ts_encode_ref(x, tau, cap))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(3):
        for graph, st in zip(graphs, streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                graph.replay()
        torch.cuda.synchronize()
        for out, (_, want) in zip(outs, calls):
            assert _same_bits(out, want)


def test_ts_encode_refuses_bad_card_input(cuda_device):
    """A CPU tensor, a wrong dtype, a non-contiguous or a non-2-D x, and a
    negative capacity are refused without a launch."""
    x = torch.zeros((2, 64), device=cuda_device)
    before = tsm.ts_encode.launches
    for bad, cap in ((x.cpu(), 16), (x.double(), 16), (x.half(), 16),
                     (x.t(), 16), (x[None], 16), (x[0], 16), (x, -1)):
        with pytest.raises(ValueError):
            tsm.ts_encode(bad, 1.0, cap)
    assert tsm.ts_encode.launches == before


# ------------------------------------------------------------ speculation


def test_paged_decode_kernel_at_verify_rows_equals_sequential_calls(
        cuda_device):
    """K2 at the speculative verify's rows: 8 slots of 132 tokens (a
    128-token prompt and a 4-token burst), 4 columns each, 32 query rows
    over the slots' table rows repeated a column each. Within 1e-4 of its
    plain version; each column bit for bit the call the sequential decode
    step at that position makes (same table width, same route); replayed
    from a CUDA graph bit for bit."""
    rng = np.random.default_rng(29)
    slots, cols, first = 8, 4, 128
    pool = _split_pool(rng, cuda_device, 32, 128, 16, 64,
                       [first + cols] * slots)
    kc, ks, vc, vs, pool_pos, bt = pool
    rows_bt = bt.repeat_interleave(cols, dim=0)
    q_pos = torch.tensor(np.tile(first + np.arange(cols), slots),
                         dtype=torch.int32, device=cuda_device)
    q = torch.from_numpy(rng.normal(size=(slots * cols, 32, 1, 128)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    args = (kc, ks, vc, vs, pool_pos, rows_bt, q_pos)
    before = pda.paged_decode_attention.launches
    got = pda.paged_decode_attention(q, *args)
    assert pda.paged_decode_attention.launches == before + 1
    want = pda.paged_decode_attention_ref(q, *args)
    for j in range(cols):
        one = pda.paged_decode_attention(
            q[j::cols].contiguous(), kc, ks, vc, vs, pool_pos, bt,
            q_pos[j::cols].contiguous())
        assert torch.equal(one, got[j::cols])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pda.paged_decode_attention(q, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pda.paged_decode_attention(q, *args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)


def test_paged_verify_step_on_card_matches_sequential_decode(cuda_device):
    """llama2-7b tiny (f32) on the card: a right-aligned (3, 4) verify over
    prefilled pool rows against 4 sequential paged decode steps on an equal
    pool. K2 gives each column the sequential call's bits; the projections
    differ only in their products' M, so the logits agree within 1e-4 of
    the largest and the argmax is equal wherever the top-1/top-2 margin
    exceeds that."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.kv_pool import PagedKVPool

    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = {k: v.to(cuda_device) for k, v in init_params(
        cfg, torch.Generator().manual_seed(0)).items()}
    rng = np.random.default_rng(31)
    lens, burst, s = (6, 9, 3), (4, 2, 1), 4
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    tokens = np.zeros((3, s), np.int64)
    posn = np.full((3, s), -1, np.int32)
    for r, (n, k) in enumerate(zip(lens, burst)):
        tokens[r, s - k:] = rng.integers(0, cfg.vocab_size, (k,))
        posn[r, s - k:] = np.arange(n, n + k)

    def prefilled():
        pool = PagedKVPool(cfg, num_pages=24, page_size=4, max_requests=3,
                           device=cuda_device)
        ptoks = np.zeros((3, 9), np.int64)
        ppos = np.full((3, 9), -1, np.int32)
        for r, p in enumerate(prompts):
            pool.admit(len(p), reserve_tokens=len(p) + s)
            ptoks[r, 9 - len(p):] = p
            ppos[r, 9 - len(p):] = np.arange(len(p))
        T.paged_prefill(params, cfg,
                        torch.as_tensor(ptoks, device=cuda_device),
                        pool.device_caches(),
                        torch.as_tensor(ppos, device=cuda_device), opts)
        return pool

    dev = lambda a: torch.as_tensor(a, device=cuda_device)  # noqa: E731
    with torch.inference_mode():
        pool = prefilled()
        before = pda.paged_decode_attention.launches
        got, _ = T.paged_verify_step(params, cfg, dev(tokens),
                                     pool.device_caches(), dev(posn), opts)
        assert pda.paged_decode_attention.launches - before \
            == cfg.num_layers
        got = got.cpu().numpy()
        seq = prefilled()
        for j in range(s):
            step, _ = T.paged_decode_step(params, cfg, dev(tokens[:, j:j + 1]),
                                          seq.device_caches(),
                                          dev(posn[:, j]), opts)
            step = step.cpu().numpy()
            for r in range(3):
                if posn[r, j] < 0:
                    continue
                scale = np.abs(step[r]).max()
                assert np.abs(got[r, j] - step[r]).max() <= 1e-4 * scale
                top2 = np.sort(step[r])[-2:]
                if top2[1] - top2[0] > 1e-4 * scale:
                    assert got[r, j].argmax() == step[r].argmax()


@pytest.mark.parametrize("mode", ["chunked", "packed"])
def test_speculative_scheduler_on_card_drains(cuda_device, mode):
    """llama2-7b tiny (f32) through the speculative Scheduler on the card:
    the k = 0 run's greedy streams, K2 once a layer and verify tick (each
    decode tick one verify call), and every page back in the pool."""
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(33)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, (3,)), 4)[:n]
               for n in (9, 12, 7)]

    def serve(k):
        sched = Scheduler(cfg, params, opts, num_pages=32, page_size=4,
                          max_slots=3, tick_mode=mode, speculate_k=k,
                          device=cuda_device)
        rids = [sched.submit(p, 8) for p in prompts]
        before = pda.paged_decode_attention.launches
        res = sched.run()
        return ([res[r] for r in rids], sched,
                pda.paged_decode_attention.launches - before)

    base, _, _ = serve(0)
    got, sched, k2 = serve(3)
    for g, w in zip(got, base):
        np.testing.assert_array_equal(g, w)
    assert sched.stats.spec_rounds > 0
    assert k2 == cfg.num_layers * sched.stats.steps
    assert sched.pool.pages_in_use == 0 and not sched.pool.refcount.any()


def _async_serve(cfg, params, opts, prompts, device, **server_kw):
    """The requests through AsyncLLMServer's tick thread on ``device``
    (``server_kw`` reach the paged ``LLMServer``): (token lists, K2
    launches, K3 launches, names of the threads that stepped the
    backend)."""
    import asyncio

    from repro_torch.core.sampling import SamplingParams
    from repro_torch.serving.api import LLMServer
    from repro_torch.serving.async_engine import AsyncLLMServer

    srv = LLMServer(cfg, params, opts, backend="paged", num_pages=32,
                    page_size=4, max_slots=2, prefill_chunk=4,
                    device=device, **server_kw)
    step, threads = srv.backend.step, set()

    def traced_step():
        import threading

        threads.add((threading.current_thread().name,
                     torch.cuda.current_device()))
        return step()

    srv.backend.step = traced_step

    async def go():
        engine = AsyncLLMServer(srv)
        rids = [await engine.submit(p, SamplingParams(max_tokens=6))
                for p in prompts]
        outs = [await engine.result(r) for r in rids]
        await engine.shutdown()
        return [o.tokens for o in outs]

    k2 = pda.paged_decode_attention.launches
    k3 = ppa.paged_prefill_attention.launches
    toks = asyncio.run(asyncio.wait_for(go(), 300))
    return (toks, pda.paged_decode_attention.launches - k2,
            ppa.paged_prefill_attention.launches - k3, threads)


@pytest.mark.parametrize("index", [0, 1])
def test_async_server_tick_thread_serves_on_its_card(cuda_device, index):
    """AsyncLLMServer's tick thread serves two requests through K2 (decode
    ticks) and K3 (continuation chunks) on card ``index``, inside that
    card's device scope, with the tokens of the same requests driven from
    the main thread."""
    if index >= torch.cuda.device_count():
        pytest.skip("needs a second CUDA card: the tick thread must make "
                    "the backend's card current, not card 0")
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.serving.api import LLMServer

    dev = torch.device("cuda", index)
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (11, 6)]
    got, k2, k3, threads = _async_serve(cfg, params, opts, prompts, dev)
    assert threads == {("asyncllm-tick", index)}
    assert k2 > 0 and k3 > 0
    srv = LLMServer(cfg, params, opts, backend="paged", num_pages=32,
                    page_size=4, max_slots=2, prefill_chunk=4, device=dev)
    rids = [srv.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
    want = srv.run()
    for g, rid in zip(got, rids):
        np.testing.assert_array_equal(g, want[rid].tokens)


def test_tracer_on_and_off_give_the_same_paged_streams_on_card(
        cuda_device, monkeypatch):
    """The paged scheduler on the card with a Tracer and without: the same
    streams bit for bit; only the traced run syncs the stream for its
    prefill spans (counted), and ``torch.cuda.synchronize`` is never
    called."""
    from repro_torch.serving import scheduler as scheduler_mod
    from repro_torch.serving.telemetry import Tracer

    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(43)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (13, 5, 9)]
    syncs, device_syncs = [], []
    real = scheduler_mod.stream_sync
    monkeypatch.setattr(scheduler_mod, "stream_sync",
                        lambda dev: (syncs.append(dev), real(dev)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: device_syncs.append(a))

    def serve(tracer):
        sched = Scheduler(cfg, params, opts, num_pages=32, page_size=4,
                          max_slots=2, prefill_chunk=4, telemetry=tracer,
                          device=cuda_device)
        rids = [sched.submit(p, 8) for p in prompts]
        res = sched.run()
        return [res[r] for r in rids]

    off = serve(None)
    assert syncs == []
    tracer = Tracer()
    on = serve(tracer)
    assert len(syncs) > 0 and device_syncs == []
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    assert tracer.metrics_dict()["requests.finished"] == 3


@pytest.mark.parametrize("mode", ["chunked", "packed"])
def test_disaggregated_facade_on_card_matches_single_scheduler(cuda_device,
                                                               mode):
    """llama2-7b tiny (f32) through the disaggregated facade on one card:
    the single scheduler's streams bit for bit (every prompt is cut into
    the same pieces in both), one page-stream transfer a request, the
    replicas sharing the weights, both pools drained, and the path's
    kernels launched (K2 and K3 chunked, K4 packed)."""
    from repro_torch.serving.page_transport import DisaggregatedScheduler

    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = {k: v.to(cuda_device) for k, v in init_params(
        cfg, torch.Generator().manual_seed(0)).items()}
    rng = np.random.default_rng(47)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (11, 6, 9)]
    kw = dict(num_pages=32, page_size=4, max_slots=3, tick_mode=mode,
              prefill_chunk=4 if mode == "chunked" else 256,
              device=cuda_device)
    single = Scheduler(cfg, params, opts, **kw)
    for p in prompts:
        single.submit(p, 7)
    want = single.run()
    kernels = (pda.paged_decode_attention, ppa.paged_prefill_attention,
               va.varlen_attention)
    before = [fn.launches for fn in kernels]
    ds = DisaggregatedScheduler(cfg, params, opts, **kw)
    rids = [ds.submit(p, 7) for p in prompts]
    got = ds.run()
    k2, k3, k4 = (fn.launches - b for fn, b in zip(kernels, before))
    for rid in rids:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert ds.transport.transfers == len(prompts)
    assert all(ds.decode.params[k].data_ptr() == v.data_ptr()
               for k, v in ds.prefill.params.items())
    for sched in (ds.prefill, ds.decode):
        assert sched.pool.pages_in_use == 0 and sched.pool.swap_bytes == 0
    if mode == "chunked":
        assert k2 > 0 and k3 > 0 and k4 == 0
    else:
        assert k4 > 0 and k2 == k3 == 0


def test_disaggregated_replicas_on_two_cards_serve_async(cuda_device):
    """Prefill on card 0 and decode on card 1, through AsyncLLMServer's
    tick thread: the streams of the same facade on card 0 alone, with K2
    and K3 launched."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card: the decode replica's ticks "
                    "must make card 1 current")
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.serving.api import LLMServer

    cards = [torch.device("cuda", i) for i in (0, 1)]
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(53)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (11, 6)]
    got, k2, k3, threads = _async_serve(
        cfg, params, opts, prompts, cards[0], deployment="disaggregated",
        decode_kwargs={"device": cards[1]})
    assert threads == {("asyncllm-tick", 0)}
    assert k2 > 0 and k3 > 0
    srv = LLMServer(cfg, params, opts, backend="paged", num_pages=32,
                    page_size=4, max_slots=2, prefill_chunk=4,
                    device=cards[0], deployment="disaggregated")
    rids = [srv.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
    want = srv.run()
    for g, rid in zip(got, rids):
        np.testing.assert_array_equal(g, want[rid].tokens)


# ------------------------------------------------------ mixture of experts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 12])
def test_dequant_matmul_on_expert_slices_of_one_code_matrix(cuda_device,
                                                            dtype, m):
    """K7 on expert i's rows of a split edge's (E·K, N) code matrix (a
    view, one scale row shared by the experts), at qwen2-moe-a2.7b's
    expert shapes, and on its f32 router (N 60): within 1e-5 of the plain
    version relative to the largest output."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for e, k, n in ((4, 2048, 1408), (3, 1408, 2048)):
        codes = torch.randint(-127, 128, (e * k, n), generator=gen,
                              device=cuda_device, dtype=torch.int8)
        scale = torch.rand(n, generator=gen, device=cuda_device) * 1e-2
        x = torch.randn(m, k, generator=gen, device=cuda_device).to(
            getattr(torch, dtype))
        for i in range(e):
            w = codes[i * k:(i + 1) * k]
            got = dm.dequant_matmul(x, w, scale)
            want = dm.dequant_matmul_ref(x, w, scale)
            rel = float((got - want).abs().max() / want.abs().max())
            assert rel <= 1e-5, (e, k, n, i)
    router = torch.randint(-127, 128, (2048, 60), generator=gen,
                           device=cuda_device, dtype=torch.int8)
    scale = torch.rand(60, generator=gen, device=cuda_device) * 1e-2
    x = torch.randn(m, 2048, generator=gen, device=cuda_device)
    got = dm.dequant_matmul(x, router, scale)
    want = dm.dequant_matmul_ref(x, router, scale)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b-tiny",
                                  "qwen3-moe-235b-a22b-tiny"])
def test_moe_engine_and_packed_scheduler_on_card_match_cpu(cuda_device,
                                                           name):
    """Both tiny MoE configs, the same f32 weights, int8 KV, dropless: the
    Engine's greedy tokens and the packed scheduler's on the card equal
    the CPU's; K1 runs once a layer and decode step, K4 once a layer and
    packed tick."""
    cfg = get_config(name)
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True,
                       moe_capacity_factor=0.0)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 20))
    want = Engine(cfg, params, opts, cache_len=32,
                  device="cpu").generate(prompts, 8)
    before = da.decode_attention.launches
    got = Engine(cfg, params, opts, cache_len=32,
                 device=cuda_device).generate(prompts, 8)
    assert da.decode_attention.launches - before == cfg.num_layers * 7
    np.testing.assert_array_equal(got.tokens, want.tokens)

    def serve(device):
        sched = Scheduler(cfg, params, opts, num_pages=24, page_size=4,
                          max_slots=3, tick_mode="packed", device=device)
        rids = [sched.submit(p, 6) for p in prompts]
        res = sched.run()
        assert sched.pool.pages_in_use == 0
        return [res[r] for r in rids], sched.stats

    want, _ = serve("cpu")
    k4 = va.varlen_attention.launches
    got, stats = serve(cuda_device)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert va.varlen_attention.launches - k4 \
        == cfg.num_layers * stats.packed_ticks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_on_card_repeats_its_bits(cuda_device, dtype):
    """qwen2-moe-a2.7b's layer shape (60 experts top-4, a shared expert),
    four experts' rows routed from 40 tokens: two calls give the same
    bits (the combine writes each pair's row once and sums k rows; no
    atomics), one host read of the counts each."""
    cfg = get_config("qwen2-moe-a2.7b")
    spec = cfg.pattern[0].ffn
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    d, e, f = cfg.d_model, spec.num_experts, spec.d_ff
    dt = getattr(torch, dtype)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=cuda_device)
                / shape[-2] ** 0.5).to(dt)

    params = {"w_router": w(d, e).float(), "w_gate": w(e, d, f),
              "w_up": w(e, d, f), "w_down": w(e, f, d),
              "shared": {"w_gate": w(d, 4 * f), "w_up": w(d, 4 * f),
                         "w_down": w(4 * f, d)}}
    x = torch.randn((2, 20, d), generator=gen, device=cuda_device).to(dt)
    moe.reset_stats()
    y1, a1 = moe.moe_layer(params, x, spec, 1.25)
    y2, a2 = moe.moe_layer(params, x, spec, 1.25)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    assert moe.STATS["host_syncs"] == 2 and moe.STATS["pairs"] == 2 * 160
    assert bool(torch.isfinite(y1).all())


# ----------------------------------------------- the GQA/MQA group sizes


@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kh,g", [(8, 6), (1, 48)], ids=["g6", "g48"])
def test_paged_decode_kernel_at_the_gqa_groups(cuda_device, kh, g, qdtype):
    """K2 at internlm2's G 6 (8 kv heads) and granite's G 48 (one), hd
    128, page 16: within 1e-4 of its plain version (a free slot exact
    zeros), repeated bit for bit, counted once a call."""
    rng = np.random.default_rng(31)
    pool = _pool(rng, cuda_device, p=80, kh=kh, hd=128,
                 lens=(700, 0, 129, 33))
    q = torch.from_numpy(rng.normal(size=(4, kh, g, 128)).astype(
        np.float32)).to(cuda_device, getattr(torch, qdtype))
    q_pos = torch.tensor([699, -1, 128, 32], dtype=torch.int32,
                         device=cuda_device)
    before = pda.paged_decode_attention.launches
    got = ops.paged_decode_attention(q, *pool, q_pos)
    again = ops.paged_decode_attention(q, *pool, q_pos)
    assert pda.paged_decode_attention.launches == before + 2
    want = pda.paged_decode_attention_ref(q, *pool, q_pos)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert torch.equal(got, again) and (got[1] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kh,g", [(8, 6), (1, 48)], ids=["g6", "g48"])
def test_paged_prefill_kernel_at_the_gqa_groups(cuda_device, kh, g, dtype):
    """K3 at G 6 and G 48 (its S·G query rows a kv head: 2,880 at G 48),
    hd 128, S 60: a continuation row, a padded row and a row with no
    history, within 1e-4 of its plain version; pads exact zeros."""
    rng = np.random.default_rng(32)
    rows = [(150, 60), None, (0, 45)]
    pool = _pool(rng, cuda_device, p=40, kh=kh, hd=128,
                 lens=[0 if x is None else sum(x) for x in rows])
    s, dt = 60, getattr(torch, dtype)
    q_pos = np.full((3, s), -1, np.int32)
    for i, x in enumerate(rows):
        if x is not None:
            q_pos[i, s - x[1]:] = np.arange(x[0], x[0] + x[1])
    q_pos = torch.from_numpy(q_pos).to(cuda_device)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(cuda_device, dt)

    q, kf, vf = rand(3, s, kh, g, 128), rand(3, s, kh, 128), \
        rand(3, s, kh, 128)
    got = ops.paged_prefill_attention(q, *pool, q_pos, kf, vf)
    start = ppa.first_call_position(q_pos)
    want = ppa.paged_prefill_attention_ref(q, *pool, q_pos, start, kf, vf)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert (got[q_pos < 0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kh,g", [(8, 6), (1, 48)], ids=["g6", "g48"])
def test_varlen_kernel_at_the_gqa_groups(cuda_device, kh, g, dtype):
    """K4 at G 6 and G 48, hd 128: decode rows beside a 60-token chunk
    over history, within 1e-4 of its plain version; pads exact zeros."""
    rng = np.random.default_rng(33)
    segs = [(300, 1), (90, 60), (0, 40), (17, 1)]
    args = _varlen(rng, cuda_device, segs, 4, getattr(torch, dtype), kh=kh,
                   g=g, hd=128, p=60)
    start = ops.segment_start(args[7], args[8], len(segs))
    got = ops.varlen_attention(*args[:9], start, *args[9:])
    want = va.varlen_attention_ref(*args[:9], start, *args[9:])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert (got[:, args[8] < 0] == 0).all()


@pytest.mark.parametrize("name", ["mamba2-780m", "jamba-v0.1-52b"])
def test_ssm_decode_step_on_card_matches_cpu(cuda_device, name):
    """The tiny state-space config (mamba2: two Mamba-2 layers; jamba's
    tiny: an SSM layer with an MLP and one with MoE) in f32: a 20-token
    prefill and 6 decode steps fed the same tokens on the card against the
    CPU: logits and the recurrent states within 1e-3 of their largest, the
    state kept on the card in its storage dtype; greedy Engine tokens
    equal."""
    from repro_torch.models.transformer import decode_step, prefill

    cfg = get_config(name).tiny()
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True,
                       moe_capacity_factor=0.0)
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    card = {k: v.to(cuda_device) for k, v in cpu.items()}
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 26)))
    runs = []
    for params, dev in ((cpu, "cpu"), (card, cuda_device)):
        t = toks.to(dev)
        with torch.inference_mode():
            lg, caches = prefill(params, cfg, t[:, :20], 32, opts)
            out = [lg.cpu()]
            for p in range(20, 26):
                lg, caches = decode_step(params, cfg, t[:, p:p + 1], caches,
                                         p, opts)
                out.append(lg.cpu())
        runs.append((torch.stack(out), caches))
    (want, wc), (got, gc) = runs
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= 1e-3
    for a, b in zip(gc, wc):
        if isinstance(a, tuple):
            assert a[1].device.type == "cuda" and a[1].dtype == torch.float32
            assert ((a[1].cpu() - b[1]).abs().max()
                    / b[1].abs().max()).item() <= 1e-3
    prompts = toks[:, :20].numpy()
    eng = [Engine(cfg, p, opts, cache_len=32, device=d).generate(
        prompts, 8).tokens for p, d in ((cpu, "cpu"), (card, cuda_device))]
    np.testing.assert_array_equal(eng[0], eng[1])


def test_decode_attention_at_the_modal_steps_replays_from_a_cuda_graph(
        cuda_device):
    """K1 at qwen2-vl-2b's (K 2, G 6, hd 128) and musicgen-medium's (K 24,
    G 1, hd 64) decode shapes captured in CUDA graphs: each replay equals
    the eager call bit for bit, and the eager call its plain version
    within 1e-4."""
    for name in ("qwen2vl_g6", "musicgen_hd64"):
        args, q_pos = _k1_case(cuda_device, name, torch.bfloat16)
        eager = da.decode_attention(*args, q_pos)
        torch.cuda.synchronize()
        np.testing.assert_allclose(
            eager.cpu().numpy(),
            da.decode_attention_ref(*args, q_pos).cpu().numpy(), rtol=0,
            atol=1e-4)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            da.decode_attention(*args, q_pos)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = da.decode_attention(*args, q_pos)
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager), name


@pytest.mark.parametrize("name", ["qwen2-vl-2b", "musicgen-medium"])
def test_modal_configs_on_card_match_cpu(cuda_device, name):
    """The tiny vision-stub and codebook configs in f32, int8 KV: a
    20-token prefill (qwen2-vl's first 8 rows its projected patches;
    musicgen's (B, S, 4) codebooks and sinusoidal positions) and 6 decode
    steps fed the same tokens on the card against the CPU, logits within
    1e-3 of their largest; greedy ``Engine`` tokens equal (qwen2-vl with
    patches, musicgen (B, S + 8, 4)), K1 once a layer and decode step."""
    from repro_torch.models.transformer import decode_step, prefill

    cfg = get_config(name).tiny()
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    card = {k: v.to(cuda_device) for k, v in cpu.items()}
    rng = np.random.default_rng(4)
    shape = (2, 26) + ((4,) if cfg.num_codebooks > 1 else ())
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
    patches = None
    if cfg.embed == "vlm":
        patches = torch.from_numpy(rng.normal(size=(
            2, cfg.num_patches, cfg.d_vision)).astype(np.float32))
    runs = []
    for params, dev in ((cpu, "cpu"), (card, cuda_device)):
        t = toks.to(dev)
        pt = None if patches is None else patches.to(dev)
        with torch.inference_mode():
            lg, caches = prefill(params, cfg, t[:, :20], 32, opts, pt)
            out = [lg.cpu()]
            for p in range(20, 26):
                lg, caches = decode_step(params, cfg, t[:, p:p + 1], caches,
                                         p, opts)
                out.append(lg.cpu())
        runs.append(torch.stack(out))
    want, got = runs
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-3
    prompts = toks[:, :20].numpy()
    before = da.decode_attention.launches
    eng = [Engine(cfg, p, opts, cache_len=32, device=d).generate(
        prompts, 8, patches=None if patches is None else patches.numpy())
        for p, d in ((card, cuda_device), (cpu, "cpu"))]
    assert da.decode_attention.launches - before == cfg.num_layers * 7
    np.testing.assert_array_equal(eng[0].tokens, eng[1].tokens)
    assert eng[0].tokens.shape == (2, 28) + shape[2:]


# ----------------------------------------- K7 on int16 codes (9-15 bits)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (1, 4096, 11008),
                                   (1, 11008, 4096), (4, 4096, 11008),
                                   (1, 2048, 60), (3, 100, 17),
                                   (4, 200, 84), (96, 4096, 4096),
                                   (96, 130, 50), (96, 11008, 4096)])
def test_dequant_matmul_int16_codes_match_plain_version(cuda_device, dtype,
                                                        m, k, n):
    """K7 on 12-bit codes in int16: the GEMV up to 4 rows (``gemv16_kernel``
    at 8 codes a 16-byte load; 8-byte and 1-code loads for a ragged N such
    as qwen2-moe's router, N 60), the CUDA cores above, never the tensor
    cores; within 1e-5 of |x| @ |codes| * scale of the plain version, two
    calls bit-identical, counted by route and by code width."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda_device, getattr(torch, dtype))
    codes = torch.from_numpy(rng.integers(-2047, 2048, (k, n)).astype(
        np.int16)).to(cuda_device)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, (n,)).astype(
        np.float32)).to(cuda_device)
    routes = dict(dm.dequant_matmul.route_launches)
    widths = dict(dm.dequant_matmul.code_launches)
    got = ops.dequant_matmul(x, codes, scale)
    again = dm.dequant_matmul(x, codes, scale)
    routes["gemv" if m <= dm.GEMV_MAX_M else "cuda_cores"] += 2
    widths["int16"] += 2
    assert dm.dequant_matmul.route_launches == routes
    assert dm.dequant_matmul.code_launches == widths
    want = dm.dequant_matmul_ref(x, codes, scale)
    bound = (x.float().abs() @ codes.float().abs() * scale).max()
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(bound)
    assert torch.equal(got, again)


def test_dequant_matmul_refuses_codes_of_other_widths(cuda_device):
    """Codes other than int8 and int16 are refused, and never widened or
    handed to the plain version: no launch is counted."""
    x = torch.zeros((1, 64), device=cuda_device)
    scale = torch.ones(8, device=cuda_device)
    before = dm.dequant_matmul.launches
    for dtype in (torch.int32, torch.uint8, torch.float16):
        with pytest.raises(ValueError):
            dm.dequant_matmul(x, torch.zeros((64, 8), dtype=dtype,
                                             device=cuda_device), scale)
    assert dm.dequant_matmul.launches == before


def test_int16_gemv_replays_from_a_cuda_graph(cuda_device):
    """The int16 GEMV at w_up (split K, tickets), captured in a CUDA graph:
    each replay equals the eager call bit for bit."""
    rng = np.random.default_rng(28)
    x = torch.from_numpy(rng.normal(size=(1, 4096)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    codes = torch.from_numpy(rng.integers(-2047, 2048, (4096, 11008)).astype(
        np.int16)).to(cuda_device)
    scale = torch.from_numpy(rng.uniform(1e-6, 1e-4, (11008,)).astype(
        np.float32)).to(cuda_device)
    assert dm.gemv_plan(1, 11008, 4096, 8, dm._sm_count(0), 2)[1] > 1
    eager = dm.dequant_matmul(x, codes, scale)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dm.dequant_matmul(x, codes, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dm.dequant_matmul(x, codes, scale)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_split_engine_wide_front_on_card_matches_cpu(cuda_device):
    """llama2-7b tiny in f32 through the split engine at qw_front 12 (int16
    codes, TS + TAB-Q, int8 KV): the card's tokens and uplink bits equal
    the CPU run's, and every K7 launch takes int16 codes."""
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    opsc = OPSCConfig(split_layer=1, qw_front=12, tau=0.5)
    want, wst = SplitEngine(cfg, params, opsc, opts=opts, cache_len=32,
                            device="cpu").generate(prompts, 6)
    widths = dict(dm.dequant_matmul.code_launches)
    got, gst = SplitEngine(cfg, params, opsc, opts=opts, cache_len=32,
                           device=cuda_device).generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    assert gst.uplink_bits_measured == wst.uplink_bits_measured
    assert dm.dequant_matmul.code_launches["int16"] \
        - widths["int16"] == 7 * 6
    assert dm.dequant_matmul.code_launches["int8"] == widths["int8"]


def test_engine_act_bits_on_card_matches_cpu(cuda_device):
    """The uniform activation quantization (act_bits 8, int8 KV) on the
    tiny llama in f32: the card's greedy tokens equal the CPU's and the
    logprobs agree within 5e-3 (an AIQ or KV code may land a step apart
    where the two devices' f32 sums differ in the last bit)."""
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True,
                       act_bits=8)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10))
    want = Engine(cfg, params, opts, cache_len=32,
                  device="cpu").generate(prompts, 8)
    got = Engine(cfg, params, opts, cache_len=32,
                 device=cuda_device).generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, rtol=1e-4,
                               atol=5e-3)

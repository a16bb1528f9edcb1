"""The port's serving stack against the JAX package: ``Engine`` greedy
streams and logprobs equal to the reference engine's on the same weights,
``LLMServer(backend="fused")`` stop / abort / release / mixed-length /
event-order behaviour (mirroring ``tests/test_serving_api.py``), the
induction vehicle's copy accuracy, the port importing nothing of JAX, and
entry points refusing to run without a device."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from benchmarks.common import HALF, copy_prompts, vehicle_config
from repro.configs import get_config as jax_config
from repro.core.sampling import SamplingParams as JSP
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.training.checkpoint import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.opsc import OPSCConfig
from repro_torch.core.sampling import SamplingParams
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import from_jax_params, load_npz_checkpoint
from repro_torch.serving.api import LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.split_engine import SplitEngine

torch.set_num_threads(2)

OPTS_Q = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
JOPTS_Q = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                         quantized_kv=True, moe_capacity_factor=0.0)
# logprobs across frameworks: f32 log-softmax of logits that agree to ~1e-5
LP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny_model():
    cfg = get_config("llama2-7b-tiny")
    jparams = JT.init_params(jax_config("llama2-7b-tiny"),
                             jax.random.PRNGKey(0))
    return cfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams))


def _server(cfg, params, **kw):
    return LLMServer(cfg, params, OPTS_Q, backend="fused", cache_len=32,
                     device="cpu", **kw)


def _engine(cfg, params, cache_len=32):
    return Engine(cfg, params, OPTS_Q, cache_len=cache_len, device="cpu")


# ---------------------------------------------------- engine against JAX


def test_engine_generate_matches_jax(tiny_model):
    cfg, jparams, params = tiny_model
    prompts = np.random.default_rng(0).integers(0, 256, (3, 8))
    want = JaxEngine(jax_config("llama2-7b-tiny"), jparams, JOPTS_Q,
                     cache_len=32).generate(prompts, 6)
    got = _engine(cfg, params).generate(prompts, 6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == 6 and got.logprobs.shape == (3, 6)
    np.testing.assert_allclose(got.logprobs, want.logprobs, **LP_TOL)
    zero = _engine(cfg, params).generate(prompts, 0)
    np.testing.assert_array_equal(zero.tokens, prompts)


def test_engine_generate_requests_matches_jax(tiny_model):
    """Per-request params: greedy rows, a biased greedy row and per-row
    max_tokens give the reference's tokens; a sampled row is seeded and
    deterministic."""
    cfg, jparams, params = tiny_model
    prompts = np.random.default_rng(1).integers(0, 256, (3, 6))
    sps = [dict(max_tokens=5), dict(max_tokens=7, logit_bias={9: 50.0}),
           dict(max_tokens=4)]
    want = JaxEngine(jax_config("llama2-7b-tiny"), jparams, JOPTS_Q,
                     cache_len=32).generate_requests(
        prompts, [JSP(**s) for s in sps])
    got = _engine(cfg, params).generate_requests(
        prompts, [SamplingParams(**s) for s in sps])
    assert got.steps == want.steps == 7
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert np.all(got.tokens[1, 6:] == 9)
    np.testing.assert_allclose(got.logprobs, want.logprobs, **LP_TOL)
    mixed = [SamplingParams(max_tokens=5),
             SamplingParams(max_tokens=5, temperature=0.8, top_p=0.9, seed=3)]
    a = _engine(cfg, params).generate_requests(prompts[:2], mixed)
    b = _engine(cfg, params).generate_requests(prompts[:2], mixed)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.tokens[0], got.tokens[0, :11])


def test_induction_vehicle_copy_accuracy_equals_jax():
    """The committed induction checkpoint, loaded with numpy alone, copies
    as well through the port's int8-KV engine as through the reference's,
    token for token."""
    path = os.path.join("experiments", "vehicles", "induction")
    jcfg = vehicle_config()
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))))
    jparams, _ = restore_checkpoint(path, template)
    cfg = get_config("llama2-7b-tiny")
    cfg = type(cfg)(**{**cfg.__dict__, "vocab_size": jcfg.vocab_size,
                       "num_blocks": jcfg.num_blocks})
    prompts = copy_prompts(16)
    want = JaxEngine(jcfg, jparams, JOPTS_Q, cache_len=64).generate(
        prompts[:, :HALF + 1], HALF).tokens
    got = Engine(cfg, load_npz_checkpoint(path), OPTS_Q, cache_len=64,
                 device="cpu").generate(prompts[:, :HALF + 1], HALF).tokens
    np.testing.assert_array_equal(got, want)
    acc = float(np.mean(got[:, HALF + 1:] == prompts[:, :HALF]))
    assert acc == float(np.mean(want[:, HALF + 1:] == prompts[:, :HALF]))
    assert acc > 0.9  # the vehicle really copies


# ------------------------------------------------ LLMServer fused backend


def test_abort_on_fused_backend_cuts_stream(tiny_model):
    cfg, _, params = tiny_model
    p = np.random.default_rng(10).integers(0, 256, (4,))
    srv = _server(cfg, params)
    rid = srv.submit(p, SamplingParams(max_tokens=6))
    events = list(srv.backend.step())  # computes + streams token 0
    assert [e.index for e in events if e.rid == rid] == [0]
    assert srv.abort(rid)
    tail = list(srv.stream())
    assert [(e.finished, e.finish_reason) for e in tail if e.rid == rid] \
        == [(True, "abort")]
    out = srv.outputs()[rid]
    assert out.finish_reason == "abort" and out.tokens.shape[0] == 1
    assert not srv.pending and not srv.abort(rid)


def test_abort_queued_request_never_runs(tiny_model):
    cfg, _, params = tiny_model
    rng = np.random.default_rng(5)
    srv = _server(cfg, params)
    ra = srv.submit(rng.integers(0, 256, (4,)), SamplingParams(max_tokens=3))
    rb = srv.submit(rng.integers(0, 256, (4,)), SamplingParams(max_tokens=3))
    assert srv.abort(rb)
    outs = srv.run()
    assert outs[rb].finish_reason == "abort" and outs[rb].tokens.shape[0] == 0
    assert outs[ra].finish_reason == "length"


def test_streaming_order_invariant(tiny_model):
    """Per request, token events arrive in position order 0,1,2,…;
    requests interleave; each ends with exactly one finish marker; event
    logprobs are the engine's."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, (4,)) for _ in range(3)]
    srv = _server(cfg, params)
    rids = [srv.submit(p, SamplingParams(max_tokens=5, seed=i))
            for i, p in enumerate(prompts)]
    events = list(srv.stream())
    seen = {r: [] for r in rids}
    for ev in events:
        if not ev.finished:
            seen[ev.rid].append(ev.index)
    assert all(seen[r] == list(range(5)) for r in rids)
    order = [ev.rid for ev in events if not ev.finished]
    assert any(order[i] != order[i + 1] for i in range(len(order) - 1))
    fins = [ev for ev in events if ev.finished]
    assert sorted(ev.rid for ev in fins) == sorted(rids)
    assert all(ev.token == -1 and ev.finish_reason == "length" for ev in fins)
    want = _engine(cfg, params).generate(np.stack(prompts), 5).logprobs
    got = [[ev.logprob for ev in events if ev.rid == r and not ev.finished]
           for r in rids]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)


def test_release_drops_finished_outputs(tiny_model):
    cfg, _, params = tiny_model
    p = np.random.default_rng(11).integers(0, 256, (4,))
    srv = _server(cfg, params)
    rid = srv.submit(p, SamplingParams(max_tokens=3))
    assert not srv.release(rid)
    srv.run()
    assert rid in srv.outputs() and srv.metrics()["requests.retained"] == 1
    assert srv.release(rid)
    assert rid not in srv.outputs() and not srv.release(rid)


def test_fused_backend_mixed_lengths_and_stop(tiny_model):
    cfg, _, params = tiny_model
    rng = np.random.default_rng(9)
    p1, p2 = rng.integers(0, 256, (5,)), rng.integers(0, 256, (8,))
    eng = _engine(cfg, params)
    free1 = eng.generate(p1[None], 6).tokens[0]
    stop = int(free1[5 + 1])  # second generated token
    srv = _server(cfg, params)
    r1 = srv.submit(p1, SamplingParams(max_tokens=6, stop_token_ids=(stop,)))
    r2 = srv.submit(p2, SamplingParams(max_tokens=3))
    outs = srv.run()
    assert outs[r1].finish_reason == "stop"
    np.testing.assert_array_equal(outs[r1].full_tokens, free1[: 5 + 2])
    np.testing.assert_array_equal(outs[r2].full_tokens,
                                  eng.generate(p2[None], 3).tokens[0])
    m = srv.metrics()
    assert m["requests.reason.stop"] == 1 and m["requests.reason.length"] == 1
    assert m["requests.ttft_ticks.count"] == 2


def test_llm_server_refuses_unported_backends_and_bad_input(tiny_model):
    """Every backend is ported; an unported deployment of the paged one is
    refused, and so is a split backend without its OPSC config. The
    default backend (``"paged"``) serves on the CPU when asked for it, and
    so does a traced fused backend."""
    cfg, _, params = tiny_model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LLMServer(cfg, params, OPTS_Q, deployment="sharded", device="cpu")
    with pytest.raises(ValueError, match="opsc"):
        LLMServer(cfg, params, OPTS_Q, backend="split", device="cpu")
    srv = LLMServer(cfg, params, OPTS_Q, device="cpu")  # "paged" by default
    p = np.random.default_rng(2).integers(0, 256, (5,))
    rid = srv.submit(p, SamplingParams(max_tokens=3))
    np.testing.assert_array_equal(srv.run()[rid].full_tokens,
                                  _engine(cfg, params).generate(
                                      p[None], 3).tokens[0])
    with pytest.raises(ValueError, match="backend"):
        LLMServer(cfg, params, OPTS_Q, backend="warp")
    # telemetry is ported: a traced fused server serves the same tokens and
    # lands its span (tests/test_torch_telemetry.py holds it further)
    srv = LLMServer(cfg, params, OPTS_Q, backend="fused", telemetry=True,
                    cache_len=32, device="cpu")
    rid = srv.submit(p, SamplingParams(max_tokens=3))
    np.testing.assert_array_equal(srv.run()[rid].full_tokens,
                                  _engine(cfg, params).generate(
                                      p[None], 3).tokens[0])
    assert "fused_generate" in {sp.name for sp in srv.tracer.spans}
    with pytest.raises(ValueError, match="one request per row"):
        _server(cfg, params).submit(np.ones((4, 16), np.int32))
    srv = _server(cfg, params)
    srv.submit(np.ones(30, np.int32), SamplingParams(max_tokens=8))
    with pytest.raises(ValueError, match="cache_len"):
        srv.run()


# ------------------------------------------------------ devices, imports


def test_entry_points_raise_without_a_device(tiny_model, monkeypatch):
    """No ``device`` and no CUDA: every entry point raises instead of
    running on the CPU."""
    from repro_torch.launch import serve

    cfg, _, params = tiny_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params, OPTS_Q)
    for backend, kw in (("fused", {}), ("paged", {}),
                        ("split", {"opsc": OPSCConfig(split_layer=1)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LLMServer(cfg, params, OPTS_Q, backend=backend, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SplitEngine(cfg, params, OPSCConfig(split_layer=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler(cfg, params, OPTS_Q)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVPool(cfg, num_pages=8, max_requests=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama2-7b", "--tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama2-7b", "--tiny", "--split"])
    serve.main(["--arch", "llama2-7b", "--tiny", "--batch", "1", "--new", "2",
                "--quantized-kv", "--device", "cpu"])
    serve.main(["--arch", "llama2-7b", "--tiny", "--batch", "1", "--new", "2",
                "--quantized-kv", "--device", "cpu", "--split",
                "--qw-front", "4"])


def test_port_imports_nothing_of_jax():
    """Importing every module of the port loads neither ``jax`` nor the
    reference package."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for name in mods:\n"
        "    __import__(name)\n"
        "assert {'repro_torch.serving.async_engine', "
        "'repro_torch.serving.http', 'repro_torch.serving.telemetry', "
        "'repro_torch.data.pipeline'} <= set(mods)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": src},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 25  # every module was imported

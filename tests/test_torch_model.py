"""The port's configs, weight bridge and model against the JAX package:
the copied configs are field for field the reference's, the bridge round
trip is exact, and teacher-forced prefill and decode logits on llama2-7b
tiny (same weights, carried across) agree with quantized KV off and on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.params import (from_jax_params, init_params,
                                load_npz_checkpoint, param_specs,
                                to_jax_params)
from repro_torch.serving.engine import Engine

torch.set_num_threads(2)

# f32 logits across frameworks: the matmuls sum in another order, and with
# quantized KV an int8 code can land one step apart when a key differs in
# its last bit; 1e-4 of the largest logit bounds both (seen: ~1e-5)
REL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_config("llama2-7b").tiny()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, from_jax_params(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("name", ["llama2-7b", "llama2-13b",
                                  "llama2-7b-tiny", "gemma2-2b",
                                  "gemma2-2b-tiny", "h2o-danube-3-4b",
                                  "h2o-danube-3-4b-tiny", "qwen2-moe-a2.7b",
                                  "qwen2-moe-a2.7b-tiny",
                                  "qwen3-moe-235b-a22b",
                                  "qwen3-moe-235b-a22b-tiny"])
def test_configs_equal_the_reference(name):
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jax_config(name))


# the llama cases keep their ids; the MoE ones carry an f32 router
@pytest.mark.parametrize("dtype,name", [
    pytest.param(dt, name, id=dt if name == "llama2-7b" else f"{dt}-{name}")
    for name in ("llama2-7b", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")
    for dt in ("float32", "bfloat16")])
def test_bridge_round_trip_is_exact(dtype, name):
    cfg = jax_config(name).tiny()
    tree = jax.tree.map(np.asarray, JT.init_params(
        cfg, jax.random.PRNGKey(1), getattr(jnp, dtype)))
    flat = from_jax_params(tree)
    assert all(str(t.dtype) == ("torch.float32" if k.endswith("w_router")
                                else f"torch.{dtype}")
               for k, t in flat.items())
    back = to_jax_params(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_init_params_layout_and_scales():
    """Same keys and shapes as the reference's pytree; norms are ones and
    the draws have the reference's scales."""
    cfg = get_config("llama2-7b").tiny()
    want = {k: v.shape for k, v in from_jax_params(jax.tree.map(
        np.asarray, JT.init_params(jax_config("llama2-7b").tiny(),
                                   jax.random.PRNGKey(0)))).items()}
    params = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in params.items()} == want
    for key, (_, scale) in param_specs(cfg).items():
        t = params[key]
        if scale is None:
            assert bool((t == 1).all()), key
        else:
            assert abs(float(t.std()) / scale - 1) < 0.1, key
    # full width: the published llama2-7b parameter count
    full = param_specs(get_config("llama2-7b"))
    n = sum(int(np.prod(shape)) for shape, _ in full.values())
    assert n == get_config("llama2-7b").total_params() == 6_738_415_616


def test_npz_checkpoint_loads_the_vehicle():
    params = load_npz_checkpoint("experiments/vehicles/induction")
    data = np.load("experiments/vehicles/induction/arrays.npz")
    assert sorted(params) == sorted(data.files)
    for k in data.files:
        np.testing.assert_array_equal(params[k].numpy(), data[k])


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("quantized", [False, True])
def test_teacher_forced_logits_match_jax(tiny, quantized):
    """Prefill on 8 tokens then 4 decode steps fed the same tokens: the
    logits agree at every step within REL."""
    cfg_j, pj, pt = tiny
    cfg_t = get_config("llama2-7b-tiny")
    toks = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(np.int32)
    oj = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=quantized)
    ot = TT.RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=quantized)
    lj, cj = JT.prefill(pj, cfg_j, jnp.asarray(toks[:, :8]), None, 16, oj)
    lt, ct = TT.prefill(pt, cfg_t, torch.as_tensor(toks[:, :8]), 16, ot)
    assert _rel(lt.numpy(), lj) <= REL
    for p in range(8, 12):
        lj, cj = JT.decode_step(pj, cfg_j, jnp.asarray(toks[:, p:p + 1]), cj,
                                jnp.int32(p), oj)
        lt, ct = TT.decode_step(pt, cfg_t, torch.as_tensor(toks[:, p:p + 1]),
                                ct, torch.tensor(p, dtype=torch.int32), ot)
        assert _rel(lt.numpy(), lj) <= REL, p
    assert ct[0].k.dtype == (torch.int8 if quantized else torch.bfloat16)


def test_greedy_tokens_match_jax_under_margin_rule(tiny):
    """Greedy generation with the int8 cache: tokens equal the reference's
    at every step up to the first whose top-1/top-2 logit margin (in the
    reference's stepwise logits) is within the logit tolerance."""
    cfg_j, pj, pt = tiny
    cfg_t = get_config("llama2-7b-tiny")
    prompts = np.random.default_rng(3).integers(0, 256, (3, 8)).astype(np.int32)
    n = 8
    oj = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    got = Engine(cfg_t, pt, TT.RuntimeOpts(q_chunk=16, kv_chunk=16,
                                           quantized_kv=True),
                 cache_len=32, device="cpu").generate(prompts, n).tokens
    logits, caches = JT.prefill(pj, cfg_j, jnp.asarray(prompts), None, 32, oj)
    want, margins = [], []
    for t in range(n):
        lg = np.asarray(logits)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append((top2[:, 1] - top2[:, 0]) / np.abs(lg).max())
        nxt = lg.argmax(-1).astype(np.int32)
        want.append(nxt)
        logits, caches = JT.decode_step(pj, cfg_j, jnp.asarray(nxt[:, None]),
                                        caches, jnp.int32(8 + t), oj)
    want, margins = np.stack(want, 1), np.stack(margins, 1)
    for r in range(3):
        close = np.nonzero(margins[r] <= REL)[0]
        upto = close[0] + 1 if close.size else n
        np.testing.assert_array_equal(got[r, 8:8 + upto], want[r, :upto])
    np.testing.assert_array_equal(got[:, :8], prompts)

"""The port's training forward and gradients against the JAX package, for
every registered config's ``tiny()`` on bridged weights: ``forward_train``'s
logits and MoE auxiliary loss, and ``loss_fn``'s loss and every leaf's
gradient against ``jax.grad`` of the reference's ``loss_fn`` (qwen2-vl with
patches, musicgen with (B, S, K) codebook tokens, windows and soft caps
past the tiny window, MoE with its capacity rule, the SSM with no cache);
remat on against off; the SSD's gradient where the reference's is NaN."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import list_configs
from repro.models import transformer as JT
from repro.training import train_loop as JL
from repro_torch.configs import get_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.params import _flatten, from_jax_params
from repro_torch.training import train_loop as TL

torch.set_num_threads(2)

# f32 across frameworks: the same math summed in other orders. Measured
# largest errors on these inputs: loss 1.7e-7 relative, a leaf's gradient
# 3.8e-6 of that leaf's largest entry (jamba's A_log)
LOSS_REL = 2e-6
GRAD_REL = 5e-5
LOGIT_ATOL = 1e-5
B, S = 2, 24  # S past the tiny configs' 16-token window
CHUNK = 8


def _batch(cfg, seed=0, b=B, s=S):
    """Seeded tokens, next-token labels and a random loss mask (B, S); a
    codebook config's tokens and labels are (B, S, K), its mask (B, S);
    the vision stub gets (B, P, d_vision) patches."""
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.embed == "musicgen" else (b, s)
    tokens = rng.integers(0, cfg.vocab_size, shape)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1] * 0], 1)
    batch = {"tokens": tokens, "labels": labels,
             "loss_mask": (rng.random((b, s)) < 0.8).astype(np.float32)}
    if cfg.embed == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_vision)).astype(np.float32)
    return batch


def _reference(name, seed=0, cfg_fn=None, **batch_kw):
    jc = jax_config(name).tiny()
    if cfg_fn is not None:
        jc = cfg_fn(jc)
    jp = JT.init_params(jc, jax.random.PRNGKey(seed))
    batch = _batch(jc, seed, **batch_kw)
    return jc, jp, batch


def _port_grads(params, cfg, batch, opts):
    leaves = {k: v.detach().requires_grad_()
              for k, v in params.items()}
    loss, (ce, aux) = TL.loss_fn(
        leaves, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, opts)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss, ce, aux, dict(zip(leaves, grads))


def _leaf_errors(got: dict, want: dict) -> dict:
    """Each leaf's largest |got - want| over its largest |want|."""
    out = {}
    for k, w in want.items():
        w = np.asarray(w)
        g = np.zeros_like(w) if got[k] is None else got[k].detach().numpy()
        out[k] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    return out


@pytest.mark.parametrize("name", list_configs())
def test_loss_and_grads_match_jax_grad(name):
    """forward_train's logits and aux, then loss_fn's loss and every leaf's
    gradient, against the reference's on the same weights and batch."""
    jc, jp, batch = _reference(name)
    cfg = get_config(name).tiny()
    params = from_jax_params(jp)
    jopts = JT.RuntimeOpts(q_chunk=CHUNK, kv_chunk=CHUNK, remat=False)
    opts = TT.RuntimeOpts(q_chunk=CHUNK, kv_chunk=CHUNK, remat=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    want_logits, want_aux = JT.forward_train(jp, jc, jb["tokens"],
                                             jb.get("patches"), jopts)
    with torch.no_grad():
        logits, aux = TT.forward_train(
            params, cfg, torch.from_numpy(batch["tokens"]),
            None if "patches" not in batch
            else torch.from_numpy(batch["patches"]), opts)
    want_logits = np.asarray(want_logits)
    assert logits.shape == want_logits.shape
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=LOGIT_ATOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=LOSS_REL,
                                       abs=1e-7)

    (want_loss, (want_ce, want_aux2)), want_g = jax.value_and_grad(
        lambda p: JL.loss_fn(p, jc, jb, jopts), has_aux=True)(jp)
    loss, ce, aux2, grads = _port_grads(params, cfg, batch, opts)
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_REL)
    assert float(ce) == pytest.approx(float(want_ce), rel=LOSS_REL)
    assert float(aux2) == pytest.approx(float(want_aux2), rel=LOSS_REL,
                                        abs=1e-7)
    want_g = _flatten(want_g)
    assert set(grads) == set(want_g)
    errs = _leaf_errors(grads, want_g)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL, (worst, errs[worst])


@pytest.mark.parametrize("name", ["llama2-7b", "gemma2-2b",
                                  "qwen2-moe-a2.7b", "jamba-v0.1-52b",
                                  "musicgen-medium", "qwen2-vl-2b"])
def test_remat_matches_no_remat(name):
    """Each block under torch.utils.checkpoint gives the loss and gradients
    of the plain backward; ``moe.STATS`` count a MoE layer once, not again
    in its recompute."""
    cfg = get_config(name).tiny()
    _, jp, batch = _reference(name)
    params = from_jax_params(jp)
    runs = {}
    for remat in (False, True):
        TM.reset_stats()
        opts = TT.RuntimeOpts(q_chunk=CHUNK, kv_chunk=CHUNK, remat=remat)
        runs[remat] = (*_port_grads(params, cfg, batch, opts),
                       TM.STATS["calls"])
    (l0, _, _, g0, calls0), (l1, _, _, g1, calls1) = runs[False], runs[True]
    assert float(l0) == float(l1)
    for k in g0:
        if g0[k] is None:
            assert g1[k] is None
            continue
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-7)
    assert calls1 == calls0


def test_ssd_grads_finite_where_reference_overflows():
    """mamba2-780m tiny at the full config's chunk lengths (128 here, one
    chunk of 128 tokens): above the SSD's diagonal exp(decay) overflows, and
    the reference's where(mask, exp(decay), 0) gives NaN gradients
    (``repro/models/ssm.py:85``). The port masks the exponent first: the
    same loss, finite gradients, equal to the reference's on every leaf the
    NaN does not reach."""
    def chunked(c):
        pat = tuple(dataclasses.replace(
            ls, mixer=dataclasses.replace(ls.mixer, chunk=128))
            for ls in c.pattern)
        return dataclasses.replace(c, pattern=pat, num_blocks=1)

    jc, jp, batch = _reference("mamba2-780m", cfg_fn=chunked, b=1, s=128)
    cfg = chunked(get_config("mamba2-780m").tiny())
    jopts = JT.RuntimeOpts(remat=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, _), want_g = jax.value_and_grad(
        lambda p: JL.loss_fn(p, jc, jb, jopts), has_aux=True)(jp)
    want_g = {k: np.asarray(v) for k, v in _flatten(want_g).items()}
    nan = sorted(k for k, v in want_g.items() if not np.isfinite(v).all())
    assert "blocks/p0/mixer/A_log" in nan  # the reference's fault
    loss, _, _, grads = _port_grads(from_jax_params(jp), cfg, batch,
                                    TT.RuntimeOpts(remat=False))
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_REL)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    finite = {k: v for k, v in want_g.items() if k not in nan}
    assert len(finite) >= 8
    errs = _leaf_errors(grads, finite)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL, (worst, errs[worst])

"""The port's sampler (``repro_torch.core.sampling``): exact greedy lanes,
top-k / top-p support, per-row lanes independent of the batch, the
filtered distribution equal to the reference's, and the draws held to that
distribution (the port's hash noise cannot reproduce JAX's draws, so the
tests check distributions, as ``tests/test_sampling.py`` does)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as JS
from repro_torch.core.sampling import (SamplingParams, bias_rows,
                                       filtered_logits, sample_tokens,
                                       sampling_operands, token_logprobs,
                                       truncate_at_stop, uniform_noise)

torch.set_num_threads(2)


def _logits(r=4, v=32, seed=0):
    return torch.from_numpy(
        (np.random.default_rng(seed).normal(size=(r, v)) * 2.0).astype(
            np.float32))


def _draws(logits, params, n=200):
    """(n, R) draws: index t = 0..n-1 for every row."""
    ops = sampling_operands(params)
    r = logits.shape[0]
    return np.stack([sample_tokens(logits, ops[0],
                                   torch.full((r,), t), *ops[1:]).numpy()
                     for t in range(n)])


def _many(logits_row, sp, n):
    """n draws of one row at indices 0..n-1, as one batch of n rows."""
    ops = sampling_operands([sp] * n)
    return sample_tokens(logits_row.expand(n, -1), ops[0],
                         torch.arange(n), *ops[1:]).numpy()


def test_greedy_lanes_are_exact_argmax():
    logits = _logits()
    params = [SamplingParams(), SamplingParams(temperature=2.0, top_k=1),
              SamplingParams(temperature=1.0, seed=3),
              SamplingParams(temperature=-1.0, seed=4)]
    draws = _draws(logits, params, n=20)
    am = logits.argmax(-1).numpy()
    for r in (0, 1, 3):
        assert np.all(draws[:, r] == am[r])


def test_top_k_restricts_support():
    logits = _logits(r=2, v=16, seed=1)
    params = [SamplingParams(temperature=1.5, top_k=3, seed=s) for s in (0, 1)]
    draws = _draws(logits, params)
    for row in range(2):
        allowed = set(np.argsort(-logits[row].numpy())[:3].tolist())
        assert set(draws[:, row].tolist()) <= allowed
        assert len(set(draws[:, row].tolist())) > 1


def test_filtered_logits_equal_the_reference():
    """Temperature, top-k and nucleus filters give the reference's kept set
    and values (the distribution the draws come from)."""
    logits = _logits(r=5, v=40, seed=2)
    params = [SamplingParams(temperature=0.7, top_p=0.6),
              SamplingParams(temperature=1.3, top_k=5),
              SamplingParams(temperature=1.0, top_k=7, top_p=0.3),
              SamplingParams(temperature=2.0),
              SamplingParams(temperature=0.5, top_p=0.95, top_k=30)]
    _, temp, tk, tp = sampling_operands(params)
    got = filtered_logits(logits, temp, tk, tp).numpy()
    want = np.asarray(JS.filtered_logits(
        jnp.asarray(logits.numpy()), jnp.asarray(temp.numpy()),
        jnp.asarray(tk.numpy(), jnp.int32), jnp.asarray(tp.numpy())))
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_draws_follow_the_filtered_distribution():
    """4000 draws at indices 0..3999 match softmax(filtered logits): total
    variation distance below 0.04 (the sampling noise at this count is
    about 0.01)."""
    logits = _logits(r=1, v=12, seed=5)[0]
    for sp in (SamplingParams(temperature=1.0, seed=1),
               SamplingParams(temperature=0.8, top_p=0.9, seed=2),
               SamplingParams(temperature=1.5, top_k=4, seed=3)):
        _, temp, tk, tp = sampling_operands([sp])
        p = torch.softmax(filtered_logits(logits[None], temp, tk, tp),
                          -1)[0].numpy()
        freq = np.bincount(_many(logits, sp, 4000), minlength=12) / 4000
        assert 0.5 * np.abs(freq - p).sum() < 0.04, sp
        assert set(np.nonzero(freq)[0]) <= set(np.nonzero(p > 0)[0])


def test_top_p_one_and_top_k_zero_disable_filters():
    freq = np.bincount(_many(torch.zeros(8), SamplingParams(temperature=1.0),
                             400), minlength=8)
    assert np.all(freq > 0)


def test_rows_are_independent_of_batch_composition():
    logits = _logits(r=3, v=16, seed=3)
    params = [SamplingParams(temperature=1.1, seed=s) for s in (5, 6, 7)]
    batch = _draws(logits, params, n=25)
    solo = _draws(logits[1:2], params[1:2], n=25)
    np.testing.assert_array_equal(batch[:, 1], solo[:, 0])
    # and distinct seeds give distinct streams
    assert np.any(batch[:, 0] != batch[:, 2])


def test_uniform_noise_is_uniform_and_counter_based():
    seeds = torch.tensor([0, 1, 2 ** 32 - 1])
    u = uniform_noise(seeds, torch.tensor([0, 0, 7]), 4096)
    assert float(u.min()) > 0 and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 0.01
    again = uniform_noise(seeds[1:2], torch.tensor([0]), 4096)
    np.testing.assert_array_equal(again.numpy(), u[1:2].numpy())


def test_low_temperature_concentrates_on_argmax():
    logits = _logits(r=2, v=16, seed=6)
    cold = _draws(logits, [SamplingParams(temperature=0.05, seed=0),
                           SamplingParams(temperature=3.0, seed=0)], n=300)
    am = logits.argmax(-1).numpy()
    assert np.mean(cold[:, 0] == am[0]) > 0.95
    assert np.mean(cold[:, 1] == am[1]) < np.mean(cold[:, 0] == am[0])


def test_sampling_params_validation_and_stop():
    for kw, msg in (({"max_tokens": 0}, "max_tokens"), ({"top_k": -1}, "top_k"),
                    ({"top_p": 0.0}, "top_p"), ({"top_p": 1.5}, "top_p"),
                    ({"latency_hint": "asap"}, "latency_hint")):
        with pytest.raises(ValueError, match=msg):
            SamplingParams(**kw)
    sp = SamplingParams(stop_token_ids=(3, 5), eos_id=7)
    assert sp.stop_set == {3, 5, 7}
    assert truncate_at_stop([1, 2, 5, 3], sp) == ([1, 2, 5], "stop")
    assert truncate_at_stop([1, 2], sp) == ([1, 2], "length")
    assert SamplingParams().greedy and SamplingParams(top_k=1,
                                                      temperature=1.0).greedy


def test_logit_bias_reshapes_greedy_and_logprobs_stay_raw():
    logits = _logits(r=3, v=16, seed=7)
    am = logits.argmax(-1).numpy()
    target = int((am[0] + 1) % 16)
    params = [SamplingParams(logit_bias={target: 100.0}), SamplingParams(),
              SamplingParams(temperature=1.3, seed=11)]
    rows = bias_rows(params, 16)
    np.testing.assert_array_equal(rows, JS.bias_rows(params, 16))
    ops = sampling_operands(params)
    t = torch.zeros(3, dtype=torch.int64)
    toks = sample_tokens(logits, ops[0], t, *ops[1:], torch.from_numpy(rows))
    assert int(toks[0]) == target and int(toks[1]) == am[1]
    zero = sample_tokens(logits, ops[0], t, *ops[1:], torch.zeros(3, 16))
    np.testing.assert_array_equal(
        zero.numpy(), sample_tokens(logits, ops[0], t, *ops[1:]).numpy())
    np.testing.assert_allclose(
        token_logprobs(logits, toks).numpy(),
        np.asarray(JS.token_logprobs(jnp.asarray(logits.numpy()),
                                     jnp.asarray(toks.numpy()))),
        rtol=1e-6, atol=1e-6)

"""The port's training substrate against the JAX package: AdamW and its f32
schedule, the cross entropy, the train step with microbatch accumulation,
learning on the Zipf-Markov corpus, checkpoints crossing between the
packages bit for bit (and the hand-written msgpack subset), the
straight-through payload codec, the train launcher, and the split example
training its own vehicle."""

import dataclasses
import importlib.util
import os
import tempfile

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import payload as JPay
from repro.models import transformer as JT
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro.training import train_loop as JL
from repro_torch.configs import get_config
from repro_torch.core import payload as TPay
from repro_torch.data.pipeline import ZipfMarkov, lm_loader, make_batch
from repro_torch.launch import train as train_launcher
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import (_flatten, from_jax_opt_state, from_jax_params,
                                load_npz_checkpoint, to_jax_opt_state)
from repro_torch.training import checkpoint as TC
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TL

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# identical inputs, the same f32 operations in the same order: only pow,
# sqrt and cos may part by an ulp between the frameworks
OPT_REL = 1e-6
# the train step across frameworks (test_torch_train_families.py's bars)
LOSS_REL = 2e-6
OPTS = RuntimeOpts(q_chunk=32, kv_chunk=32, remat=False,
                   moe_capacity_factor=0.0)
JOPTS = JT.RuntimeOpts(q_chunk=32, kv_chunk=32, remat=False,
                       moe_capacity_factor=0.0)


def _np(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def _torch_np(flat: dict):
    return {k: v.detach().cpu().numpy() for k, v in flat.items()}


# ------------------------------------------------------------- optimizer


def test_lr_schedule_matches_reference_in_f32():
    """Warmup, cosine decay and floor at steps 0 to 300, f32 both sides."""
    cfg = TO.AdamWConfig(lr=1e-3, warmup_steps=100, total_steps=250,
                         min_lr_ratio=0.1)
    jcfg = JO.AdamWConfig(lr=1e-3, warmup_steps=100, total_steps=250,
                          min_lr_ratio=0.1)
    steps = np.arange(301, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: JO.lr_schedule(jcfg, s))(steps))
    got = np.array([float(TO.lr_schedule(cfg, torch.tensor(s)))
                    for s in steps], np.float32)
    assert TO.lr_schedule(cfg, torch.tensor(5)).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=OPT_REL, atol=0)
    assert got[5] == pytest.approx(5e-5) and got[100] == pytest.approx(1e-3)
    assert got[300] == pytest.approx(1e-4, rel=1e-5)


def test_adamw_matches_reference_over_five_steps():
    """Five updates on identical seeded parameters, gradients and state
    (gradients above the clip norm at step 3 only), against the jitted
    reference: parameters, moments, count, grad norm and lr."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 16), "blocks": {"p0": {"ln1": (2, 16),
                                              "w_up": (2, 16, 32)}}}

    def tree(fn, node=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in node.items()}

    jparams = tree(lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32))
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                         weight_decay=0.1, grad_clip=1.0)
    jcfg = JO.AdamWConfig(**dataclasses.asdict(cfg))
    jstate = JO.adamw_init(jparams)
    params, state = from_jax_params(jparams), from_jax_opt_state(jstate)
    assert state.count.dtype == torch.int32
    update = jax.jit(lambda g, s, p: JO.adamw_update(jcfg, g, s, p))
    clipped = []
    for step in range(5):
        scale = 3.0 if step == 2 else 0.02
        jgrads = tree(lambda s: jnp.asarray(
            rng.standard_normal(s) * scale, jnp.float32))
        jparams, jstate, jm = update(jgrads, jstate, jparams)
        params, state, m = TO.adamw_update(cfg, from_jax_params(jgrads),
                                           state, params)
        clipped.append(float(jm["grad_norm"]) > cfg.grad_clip)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=OPT_REL)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=OPT_REL)
        for got, want in ((params, jparams), (state.mu, jstate.mu),
                          (state.nu, jstate.nu)):
            want = _np(want)
            for k, g in _torch_np(got).items():
                np.testing.assert_allclose(g, want[k], rtol=OPT_REL,
                                           atol=1e-9, err_msg=k)
        assert int(state.count) == int(jstate.count) == step + 1
    assert clipped == [False, False, True, False, False]
    # the bridge carries a state back bit for bit
    mu, nu, count = to_jax_opt_state(state)
    back = from_jax_opt_state(JO.AdamWState(mu, nu, count))
    assert all(torch.equal(back.mu[k], state.mu[k]) for k in state.mu)
    assert int(back.count) == 5


def test_adamw_reduces_quadratic():
    cfg = TO.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                         weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = TO.adamw_init(params)
    for _ in range(150):
        params, state, _ = TO.adamw_update(cfg, {"w": 2 * params["w"]},
                                           state, params)
    assert float(params["w"].abs().max()) < 0.2


# -------------------------------------------------------------- the loss


@pytest.mark.parametrize("codebooks", [0, 4])
def test_cross_entropy_matches_reference(codebooks):
    """Masked CE over (B, S, V) logits, and over (B, S, K, V) with (B, S, K)
    labels and a (B, S) mask (the codebook axis averaged first); an
    all-zero mask row and an all-zero mask."""
    rng = np.random.default_rng(codebooks)
    shape = (3, 7, codebooks) if codebooks else (3, 7)
    logits = rng.standard_normal((*shape, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, shape)
    for mask in ((rng.random((3, 7)) < 0.6).astype(np.float32),
                 np.zeros((3, 7), np.float32)):
        mask[1] = 0.0
        want = float(JL.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels),
                                      jnp.asarray(mask)))
        got = float(TL.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(mask)))
        assert got == pytest.approx(want, rel=LOSS_REL, abs=1e-7)
    zeros = TL.cross_entropy(torch.zeros(2, 4, 8),
                             torch.zeros(2, 4, dtype=torch.long),
                             torch.ones(2, 4))
    assert float(zeros) == pytest.approx(np.log(8), rel=1e-6)


# ------------------------------------------------------ the train step


def _tiny_state(name="llama2-7b"):
    jc = jax_config(name).tiny()
    jparams, jstate = JL.init_train_state(jc, jax.random.PRNGKey(0))
    return jc, jparams, jstate


def test_grad_accumulation_matches_full_batch():
    """accum 4 against accum 1 on the reference test's batch, at its bars
    (``tests/test_training.py``): loss within 1e-4, parameters within
    5e-3; ``batch_pre_split`` on the same microbatches, bit for bit."""
    cfg = get_config("llama2-7b").tiny()
    _, jparams, _ = _tiny_state()
    params = from_jax_params(jparams)
    state = TO.adamw_init(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        rng.integers(0, cfg.vocab_size, (8, 16))).items()}
    out = {}
    for accum in (1, 4):
        tc = TL.TrainConfig(TO.AdamWConfig(lr=1e-2, warmup_steps=0,
                                           total_steps=10),
                            accum_steps=accum)
        out[accum] = TL.make_train_step(cfg, tc, OPTS)(params, state, batch)
    (p1, _, m1), (p4, _, m4) = out[1], out[4]
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-4)
    assert max(float((p1[k] - p4[k]).abs().max()) for k in p1) < 5e-3
    # a batch already cut into (accum, micro, ...) gives the same step
    tc = TL.TrainConfig(TO.AdamWConfig(lr=1e-2, warmup_steps=0,
                                       total_steps=10),
                        accum_steps=4, batch_pre_split=True)
    pre, _, m_pre = TL.make_train_step(cfg, tc, OPTS)(
        params, state, {k: v.reshape(4, 2, *v.shape[1:])
                        for k, v in batch.items()})
    assert float(m_pre["loss"]) == float(m4["loss"])
    assert all(torch.equal(pre[k], p4[k]) for k in p4)
    assert all(torch.equal(v, from_jax_params(jparams)[k])
               for k, v in params.items())  # the step wrote no input


@pytest.mark.parametrize("name", ["llama2-7b", "qwen2-moe-a2.7b"])
def test_train_step_matches_reference_step(name):
    """One step with accum 2 from the same parameters and AdamW state:
    loss, ce, aux, grad norm and lr against the reference's jitted step;
    the new moments by the grads they hold (a parameter after step 1 moves
    by about ±lr wherever a tiny gradient entry's sign parts, so it is not
    held)."""
    jc, jparams, jstate = _tiny_state(name)
    cfg = get_config(name).tiny()
    rng = np.random.default_rng(1)
    batch = make_batch(rng.integers(0, cfg.vocab_size, (4, 16)))
    opt = dict(lr=1e-2, warmup_steps=3, total_steps=10)
    jstep = jax.jit(JL.make_train_step(
        jc, JL.TrainConfig(JO.AdamWConfig(**opt), accum_steps=2), JOPTS))
    _, jnew, jm = jstep(jparams, jstate,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    step = TL.make_train_step(
        cfg, TL.TrainConfig(TO.AdamWConfig(**opt), accum_steps=2), OPTS)
    _, new, m = step(from_jax_params(jparams), from_jax_opt_state(jstate),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "ce", "aux", "grad_norm"):
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                              abs=1e-7), key
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=OPT_REL)
    # mu after one step is 0.1 · the clipped grads: held as grads are
    want_mu = _np(jnew.mu)
    for k, g in _torch_np(new.mu).items():
        w = want_mu[k]
        assert np.abs(g - w).max() <= 5e-5 * max(np.abs(w).max(), 1e-30), k


def test_train_learns_zipf_markov():
    """The port trained on the Markov corpus beats the unigram bound and
    approaches the chain's entropy rate (the reference test's bars)."""
    corpus = ZipfMarkov(vocab_size=64, branching=4, seed=0)
    cfg = dataclasses.replace(get_config("llama2-7b").tiny(), vocab_size=64)
    loader = lm_loader(corpus, batch=16, seq=32, num_batches=120)
    tc = TL.TrainConfig(TO.AdamWConfig(lr=3e-3, warmup_steps=20,
                                       total_steps=120))
    _, _, hist = TL.train(cfg, loader, tc, OPTS, log_every=1000,
                          device="cpu")
    first, last = hist[0]["ce"], hist[-1]["ce"]
    assert len(hist) == 120 and all(h["host_ms"] > 0 for h in hist)
    assert last < first * 0.7
    assert last < np.log(64) * 0.8
    assert last > corpus.entropy_rate_bits() * np.log(2.0) * 0.5


# ----------------------------------------------------------- checkpoints


def _same_tree(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and got[k].tobytes() == want[k].tobytes()
        for k in want)


def test_checkpoints_cross_between_packages_bit_for_bit():
    """(params, AdamW state) written by either package restores in the
    other bit for bit; the keys, step and meta are the reference's, and
    the port's meta.msgpack is ``msgpack.packb``'s bytes."""
    jc, jparams, jstate = _tiny_state("gemma2-2b")
    rng = np.random.default_rng(3)
    jstate = JO.AdamWState(
        jax.tree_util.tree_map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape), jnp.float32), jstate.mu),
        jax.tree_util.tree_map(lambda a: jnp.asarray(
            rng.random(a.shape), jnp.float32), jstate.nu),
        jnp.int32(17))
    params, state = from_jax_params(jparams), from_jax_opt_state(jstate)
    zeros = (jax.tree_util.tree_map(jnp.zeros_like, jparams),
             jax.tree_util.tree_map(jnp.zeros_like, jstate))
    tzeros = ({k: torch.zeros_like(v) for k, v in params.items()},
              TO.AdamWState({k: torch.zeros_like(v)
                             for k, v in state.mu.items()},
                            {k: torch.zeros_like(v)
                             for k, v in state.nu.items()},
                            torch.zeros((), dtype=torch.int32)))
    with tempfile.TemporaryDirectory() as d:
        ref, port = os.path.join(d, "ref"), os.path.join(d, "port")
        JC.save_checkpoint(ref, (jparams, jstate), step=42)
        TC.save_checkpoint(port, (params, state), step=42)
        with open(os.path.join(ref, "meta.msgpack"), "rb") as f:
            ref_meta = f.read()
        with open(os.path.join(port, "meta.msgpack"), "rb") as f:
            port_meta = f.read()
        assert port_meta == ref_meta
        assert msgpack.unpackb(port_meta) == TC.unpackb(ref_meta)
        with np.load(os.path.join(ref, "arrays.npz")) as a, \
                np.load(os.path.join(port, "arrays.npz")) as b:
            assert list(a.files) == list(b.files)
            assert "1/mu/blocks/p0/mixer/wq" in a.files
            assert "1/count" in a.files
            assert _same_tree({k: b[k] for k in b.files},
                              {k: a[k] for k in a.files})

        (tp, ts), step = TC.restore_checkpoint(ref, tzeros)
        assert step == 42
        assert _same_tree(_torch_np(tp), _np(jparams))
        assert _same_tree(_torch_np(ts.mu), _np(jstate.mu))
        assert ts.count.dtype == torch.int32 and int(ts.count) == 17
        (jp, js), step = JC.restore_checkpoint(port, zeros)
        assert step == 42
        assert _same_tree(_np(jp), _np(jparams))
        assert _same_tree(_np(js.nu), _np(jstate.nu))
        assert int(js.count) == 17

        # parameters alone, and the reader that needs only numpy
        TC.save_checkpoint(port, params, step=7)
        assert _same_tree(_torch_np(load_npz_checkpoint(port)), _np(jparams))
        restored, step = JC.restore_checkpoint(port, zeros[0])
        assert step == 7 and _same_tree(_np(restored), _np(jparams))
        with pytest.raises(ValueError, match="missing keys"):
            TC.restore_checkpoint(port, tzeros)


def test_bf16_checkpoints_are_stored_as_the_reference_stores_them():
    """bf16 leaves: the reference's file holds their bits as ``V2`` items
    and its own restore fails on them (a fault of the reference, ROADMAP
    queue 3); the port writes the same items and meta, and restores either
    file bit for bit."""
    jc = jax_config("llama2-7b").tiny()
    jparams = JT.init_params(jc, jax.random.PRNGKey(1), jnp.bfloat16)
    params = from_jax_params(jparams)
    template = {k: torch.zeros_like(v) for k, v in params.items()}
    with tempfile.TemporaryDirectory() as d:
        ref, port = os.path.join(d, "ref"), os.path.join(d, "port")
        JC.save_checkpoint(ref, jparams, step=1)
        TC.save_checkpoint(port, params, step=1)
        for name in ("meta.msgpack",):
            with open(os.path.join(ref, name), "rb") as a, \
                    open(os.path.join(port, name), "rb") as b:
                assert a.read() == b.read()
        with np.load(os.path.join(ref, "arrays.npz")) as a, \
                np.load(os.path.join(port, "arrays.npz")) as b:
            assert _same_tree({k: b[k] for k in b.files},
                              {k: a[k] for k in a.files})
        for path in (ref, port):
            got, _ = TC.restore_checkpoint(path, template)
            assert all(got[k].dtype == torch.bfloat16
                       and torch.equal(got[k], params[k]) for k in params)
            assert all(torch.equal(v, params[k])
                       for k, v in load_npz_checkpoint(path).items())
        with pytest.raises(ValueError):
            JC.restore_checkpoint(ref, jax.tree_util.tree_map(
                jnp.zeros_like, jparams))


@pytest.mark.parametrize("obj", [
    {"step": 0, "keys": {}},
    {"step": 2 ** 40, "keys": {"a" * 40: {"shape": [], "dtype": "int32"}}},
    [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
     -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63],
    {"x" * 300: list(range(20)), "m": {str(i): i for i in range(20)},
     "s": "é" * 40, "t": ("a", -5)},
    {str(i): [i] * 70000 for i in range(2)}])
def test_msgpack_subset_is_msgpack(obj):
    """The port's writer gives ``msgpack.packb``'s bytes; its reader reads
    them back; a type outside the subset is refused."""
    data = TC.packb(obj)
    assert data == msgpack.packb(obj)
    assert TC.unpackb(data) == msgpack.unpackb(data)
    with pytest.raises(TypeError):
        TC.packb([obj, 1.5])
    with pytest.raises(ValueError):
        TC.unpackb(msgpack.packb([obj, None]))


# ------------------------------------------------- straight-through codec


def _activations(rows=32, d=64, seed=0, outliers=8, mag=50.0):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(rows, d)).astype(np.float32)
    flat = t.reshape(-1)
    idx = rng.choice(flat.size, size=outliers, replace=False)
    flat[idx] = mag * np.sign(flat[idx])
    return flat.reshape(rows, d)


@pytest.mark.parametrize("kw", [dict(tau=5.0, max_bits=8),
                                dict(tau=3.0, max_bits=4, delta=0.5),
                                dict(tau=5.0, fixed_bits=6, capacity=4)])
def test_encode_decode_ste_matches_reference(kw):
    """Forward: the reference's values bit for bit. Backward: the upstream
    gradient unchanged, and ``2·decode(encode(t))`` for the sum of squares
    (``tests/test_core_ts_tabq.py::test_ste_gradient_is_identity``)."""
    t = _activations(rows=16, d=128)
    want = np.asarray(JPay.encode_decode_ste(jnp.asarray(t), **kw))
    x = torch.from_numpy(t).requires_grad_()
    out = TPay.encode_decode_ste(x, **kw)
    assert np.array_equal(out.detach().numpy(), want)
    upstream = torch.from_numpy(np.random.default_rng(1).standard_normal(
        t.shape).astype(np.float32))
    (g,) = torch.autograd.grad(out, x, upstream)
    assert torch.equal(g, upstream)
    x.grad = None
    (out ** 2).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(JPay.encode_decode_ste(v, **kw) ** 2))(
        jnp.asarray(t))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(
        x.grad.numpy(),
        2 * TPay.decode(TPay.encode(torch.from_numpy(t), **kw)).numpy(),
        rtol=1e-4)


# -------------------------------------------------------- the launchers


def test_train_launcher_writes_a_checkpoint_the_reference_restores():
    """``launch.train --device cpu --tiny``: the reference's defaults, a
    history of finite losses, and a checkpoint both packages restore to the
    same bits, in the reference's parameter layout."""
    jc = jax_config("llama2-7b").tiny()
    template = jax.tree_util.tree_map(
        jnp.zeros_like, JT.init_params(jc, jax.random.PRNGKey(0)))
    with tempfile.TemporaryDirectory() as d:
        hist = train_launcher.main(["--arch", "llama2-7b", "--tiny",
                                    "--steps", "3", "--batch", "4",
                                    "--seq", "16", "--accum", "2",
                                    "--device", "cpu", "--checkpoint", d])
        assert len(hist) == 3
        assert all(np.isfinite(h["loss"]) and h["lr"] > 0 for h in hist)
        assert hist[0]["lr"] == pytest.approx(3e-3 / 10, rel=1e-6)
        restored, step = JC.restore_checkpoint(d, template)
        assert step == 3
        params = load_npz_checkpoint(d)
        assert _same_tree(_np(restored), _torch_np(params))
        assert not _same_tree(_torch_np(params), _np(template))


def test_train_launcher_refuses_a_mesh():
    """``--mesh`` trains (``tests/test_torch_sharded_train.py``); what it
    refuses is an NCCL group without a CUDA card a rank, naming the gloo
    backend that shares a device."""
    with pytest.raises(ValueError, match="--backend gloo"):
        train_launcher.main(["--arch", "llama2-7b", "--tiny", "--mesh",
                             "2x4", "--device", "cpu", "--backend", "nccl"])


def test_split_example_trains_its_vehicle():
    """``examples/split_inference_torch.py --steps 4 --device cpu``: the
    port trains the vehicle and plans on it; the report names the
    training."""
    spec = importlib.util.spec_from_file_location(
        "split_inference_torch",
        os.path.join(ROOT, "examples", "split_inference_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    report = ex.main(["--device", "cpu", "--steps", "4"])
    assert report["training"]["steps"] == 4
    assert np.isfinite(report["training"]["ce_last"])
    assert len(report["candidates"]) == 6
    assert report["solution"]["config"]["split_layer"] in (1, 2, 3)


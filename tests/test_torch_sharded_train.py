"""The port's sharded training mesh on the CPU (``launch.mesh``'s training
mesh, ``launch.sharding``, the training collectives, ``forward_train``'s
gather at use, ``moe_layer`` over data ranks, ``moe_layer_ep``, the
sharded train step, checkpoint and launcher), one gloo rank a process:

(a) the placement rules equal the reference's ``repro.launch.sharding``
    spec for spec, on ``jax.sharding.AbstractMesh`` at (2, 4), (4, 1),
    (1, 4) and (2, 2, 2), FSDP on and off, for every registered config's
    ``tiny()`` and full shapes;
(b) the sharded step (3 steps, accum 2, remat, a random loss mask) on
    meshes (1, 1), (2, 1), (1, 2), (2, 2) and (2, 1, 2) against the
    reference's unsharded jitted ``make_train_step`` on the bridged
    ``init_params(PRNGKey(0))`` weights, and a batch whose microbatch the
    data size does not divide (every data rank takes every row);
(c) qwen2-moe-a2.7b at (2, 1) with ``moe_groups`` 2 (each rank its own
    groups) and 1 (one dispatch over both ranks' rows), and
    qwen3-moe-235b-a22b at (1, 2) (its experts over ``model``), against
    the reference step with the same ``RuntimeOpts``;
(d) ``moe_layer_ep`` against the reference's own under a forced 4-device
    mesh (a subprocess), at (2, 1), (4, 1) and (2, 2), FSDP on and off,
    with a capacity that drops pairs;
(e) each rank's resident bytes against the rule's share;
(f) ``launch.train --mesh 2x2`` at 4 ranks: its checkpoint restores
    through the reference's ``restore_checkpoint`` and equals the
    unsharded launcher's.

Every world of ranks is spawned once (all at the same time, the
launcher's beside them) and its cells are asserted one by one.

Tolerances. Each step's loss, ce, aux and grad norm are held at
``METRIC_REL`` of the reference's (the unsharded port's bar is 1e-5 for
one step); the moments at ``MOMENT_REL`` of each leaf's largest entry.
AdamW turns a gradient entry near ``eps`` into a step of about ``lr``
whatever its size, so a parameter's sign-flip noise can move it by up to
``lr`` a step: the parameters are held within ``2 · Σ lr_t`` over the
steps taken (``param_atol``), and all but ``PARAM_LOOSE_SHARE`` of the
entries within ``PARAM_TIGHT``.
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs import list_configs
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch import sharding as TS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 16
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
METRIC_REL = 2e-5
MOMENT_REL = 2e-4
PARAM_TIGHT = 1e-5
PARAM_LOOSE_SHARE = 0.01
MESHES = [(2, 4), (4, 1), (1, 4), (2, 2, 2)]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str  # the test id
    dims: tuple
    arch: str
    rows: int = 4  # global batch rows (accum 2 cuts it in two)
    moe_groups: int = 1


CELLS = [
    Cell("llama-1x1", (1, 1), "llama2-7b"),
    Cell("llama-2x1", (2, 1), "llama2-7b"),
    Cell("llama-1x2", (1, 2), "llama2-7b"),
    Cell("llama-2x2", (2, 2), "llama2-7b"),
    Cell("llama-2x1x2", (2, 1, 2), "llama2-7b"),
    # a microbatch of 3 rows over 2 data ranks: every rank takes all 3
    Cell("llama-2x2-rows-replicated", (2, 2), "llama2-7b", rows=6),
    Cell("qwen2-moe-2x1-groups2", (2, 1), "qwen2-moe-a2.7b", moe_groups=2),
    Cell("qwen2-moe-2x1-groups1", (2, 1), "qwen2-moe-a2.7b", moe_groups=1),
    Cell("qwen3-moe-1x2", (1, 2), "qwen3-moe-235b-a22b"),
]
EP_CASES = [((2, 1), True), ((2, 1), False), ((4, 1), True),
            ((4, 1), False), ((2, 2), True), ((2, 2), False)]
# x (B, S, D); at (2, 1) 16 tokens a rank, 32 (token, choice) pairs for
# the 4 experts' 4 slots each: pairs drop
EP_SHAPE = (4, 8)
EP_CF = 0.5


def _cell_key(cell):
    """Cells that share the reference's run."""
    return (cell.arch, cell.rows, cell.moe_groups)


# ------------------------------------------------------------- the ranks


def _opts(cell):
    from repro_torch.models.transformer import RuntimeOpts

    return RuntimeOpts(q_chunk=SEQ, kv_chunk=SEQ, remat=True,
                       moe_groups=cell.moe_groups)


def _train_cell(cell, weights, batches) -> dict:
    """The cell's steps on this rank: each step's metrics, the resident
    bytes against the rule's share, and (rank 0) the gathered state."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.params import _to_tensor, param_specs as shapes
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TL

    cfg = get_config(cell.arch).tiny()
    mesh = make_training_mesh(cell.dims)
    place = TS.TrainPlacement(cfg, mesh)
    params = {k: _to_tensor(v) for k, v in weights.items()}
    state = TO.adamw_init(params)
    p, s = place.shard(params), place.shard(state)
    del params, state
    share = place.share_bytes({k: v[0] for k, v in shapes(cfg).items()})
    resident = {"params": place.resident_bytes(p),
                "moments": place.resident_bytes(s), "share": share}
    step = TL.make_train_step(cfg, TL.TrainConfig(
        TO.AdamWConfig(**OPT), accum_steps=2), _opts(cell), mesh=mesh)
    metrics = []
    for b in batches:
        p, s, m = step(p, s, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "resident": resident,
           "mesh": tuple(mesh.shape)}
    whole_p, whole_s = place.whole(p), place.whole(s)
    if dist.get_rank() == 0:
        out["params"] = {k: v.numpy() for k, v in whole_p.items()}
        out["mu"] = {k: v.numpy() for k, v in whole_s.mu.items()}
        out["nu"] = {k: v.numpy() for k, v in whole_s.nu.items()}
    return out


def _ep_case(dims, fsdp, inputs) -> dict:
    """``moe_layer_ep`` on this rank's rows and weight blocks."""
    from repro_torch.launch.collectives import block_index
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.models.moe import moe_layer_ep

    mesh = make_training_mesh(dims)
    data = tuple(a for a in TS.mesh_axes(mesh).values() if a.name == "data")
    idx, n = block_index(data)
    x = torch.from_numpy(inputs["x"])
    rows = x.shape[0] // n
    w = {k: torch.from_numpy(inputs[k]) for k in
         ("w_router", "w_gate", "w_up", "w_down")}
    shared = {k: torch.from_numpy(inputs[f"shared/{k}"])
              for k in ("w_gate", "w_up", "w_down")}
    if fsdp:
        for k, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
            w[k] = w[k].chunk(n, dim)[idx].contiguous()
        shared = {k: v.chunk(n, 0)[idx].contiguous()
                  for k, v in shared.items()}
    w["shared"] = shared
    spec = get_config("qwen2-moe-a2.7b").tiny().pattern[0].ffn
    y, aux = moe_layer_ep(w, x[idx * rows:(idx + 1) * rows], spec,
                          ("data",), EP_CF, fsdp, mesh=mesh)
    return {"index": idx, "y": y.numpy(), "aux": float(aux)}


def _mesh_errors(path) -> dict:
    """The training mesh's refusals inside a 2-rank group, and exact
    round trips at (2, 1): shard then gather, and a sharded checkpoint
    saved under ``path`` and restored into blocks."""
    from repro_torch.launch.mesh import make_training_mesh

    out = {}
    for dims in ((2, 2), (4,), (1, 1, 1, 2)):
        try:
            make_training_mesh(dims)
            out[dims] = None
        except ValueError as e:
            out[dims] = str(e)
    mesh = make_training_mesh((2, 1))
    cfg = get_config("qwen2-moe-a2.7b").tiny()
    from repro_torch.params import init_params

    whole = init_params(cfg, torch.Generator().manual_seed(3))
    place = TS.TrainPlacement(cfg, mesh)
    blocks = place.shard(whole)
    back = place.whole(blocks)
    out["round_trip"] = all(torch.equal(back[k], v) for k, v in whole.items())
    from repro_torch.training import checkpoint as TC
    from repro_torch.training.optimizer import adamw_init

    state = place.shard(adamw_init(whole))
    TC.save_checkpoint(path, (blocks, state), step=5, placement=place)
    meta = {k: torch.empty(v.shape, device="meta") for k, v in whole.items()}
    (got, got_state), step = TC.restore_checkpoint(
        path, (meta, adamw_init(meta)), placement=place)
    out["checkpoint"] = step == 5 and all(
        torch.equal(got[k], v) for k, v in blocks.items()) and all(
        torch.equal(got_state.mu[k], v) for k, v in state.mu.items())
    with np.load(os.path.join(path, "arrays.npz")) as a:
        out["checkpoint_whole"] = all(
            np.array_equal(a[f"0/{k}"], v.numpy()) for k, v in whole.items())
    return out


def _world(rank, world, jobs) -> dict:
    torch.set_num_threads(1)
    out = {}
    for kind, key, args in jobs:
        if kind == "train":
            out[key] = _train_cell(*args)
        elif kind == "ep":
            out[key] = _ep_case(*key, args)
        else:
            out[key] = _mesh_errors(args)
    return out


# ------------------------------------------------------------- fixtures


def _batches(cell) -> list:
    """STEPS seeded Zipf-Markov batches with a random loss mask (so the
    data ranks' mask counts differ)."""
    from repro_torch.data.pipeline import ZipfMarkov, lm_loader

    cfg = get_config(cell.arch).tiny()
    rng = np.random.default_rng(5)
    out = []
    for b in lm_loader(ZipfMarkov(cfg.vocab_size, branching=8, seed=0),
                       cell.rows, SEQ, STEPS):
        b["loss_mask"] = (rng.random(b["loss_mask"].shape) < 0.7).astype(
            np.float32)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def weights():
    """arch → the reference's ``init_params(PRNGKey(0))`` as numpy, keyed
    as the port's parameters."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    from repro_torch.params import _flatten

    return {arch: {k: np.asarray(v) for k, v in _flatten(
        JT.init_params(jax_config(arch).tiny(), jax.random.PRNGKey(0))
    ).items()} for arch in {c.arch for c in CELLS}}


def _ep_inputs() -> dict:
    """Expert weights of qwen2-moe tiny's shapes and x, from seed 11."""
    cfg = get_config("qwen2-moe-a2.7b").tiny()
    spec, d = cfg.pattern[0].ffn, cfg.d_model
    e, f = spec.num_experts, spec.d_ff
    sf = spec.num_shared * f
    rng = np.random.default_rng(11)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    x = rng.standard_normal(EP_SHAPE + (d,)).astype(np.float32)
    # the first half of the rows leans toward other experts than the
    # second, so that each data rank's own loss differs from the whole's
    x[:EP_SHAPE[0] // 2] += rng.standard_normal(d).astype(np.float32)
    return {"x": x,
            "w_router": w(d, e), "w_gate": w(e, d, f), "w_up": w(e, d, f),
            "w_down": w(e, f, d), "shared/w_gate": w(d, sf),
            "shared/w_up": w(d, sf), "shared/w_down": w(sf, d)}


_EP_REFERENCE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models.moe import moe_layer, moe_layer_ep

src, dst, cf = sys.argv[1], sys.argv[2], float(sys.argv[3])
inp = dict(np.load(src))
spec = get_config("qwen2-moe-a2.7b").tiny().pattern[0].ffn
params = {k: jnp.asarray(inp[k]) for k in ("w_router", "w_gate", "w_up",
                                          "w_down")}
params["shared"] = {k: jnp.asarray(inp["shared/" + k])
                    for k in ("w_gate", "w_up", "w_down")}
x = jnp.asarray(inp["x"])
out = {}
for dims in ((2, 1), (4, 1), (2, 2)):
    n = dims[0] * dims[1]
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(dims),
                ("data", "model"))
    for fsdp in (True, False):
        # under jit: eagerly, shard_map refuses the mesh's 'model' dim
        with jax.set_mesh(mesh):
            y, aux = jax.jit(lambda p, v: moe_layer_ep(
                p, v, spec, ("data",), cf, fsdp))(params, x)
        key = f"{dims[0]}x{dims[1]}_{int(fsdp)}"
        out["y_" + key] = np.asarray(y)
        out["aux_" + key] = np.asarray(aux)
    y, aux = moe_layer(params, x, spec, cf, groups=dims[0])
    out[f"grouped_y_{dims[0]}"] = np.asarray(y)
    out[f"grouped_aux_{dims[0]}"] = np.asarray(aux)
np.savez(dst, **out)
"""


def _ep_reference(root) -> dict:
    """The reference's ``moe_layer_ep`` (jitted, under ``jax.set_mesh``)
    and grouped ``moe_layer`` on :func:`_ep_inputs`, in a process with 4
    forced host devices."""
    src, dst = str(root / "ep_in.npz"), str(root / "ep_out.npz")
    np.savez(src, **_ep_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", _EP_REFERENCE, src, dst,
                    str(EP_CF)], env=env, check=True, timeout=300)
    return dict(np.load(dst))


def _launcher(argv, path) -> list:
    """``launch.train.main(argv)`` writing its checkpoint to ``path``; the
    history."""
    return train_launcher.main(argv + ["--checkpoint", str(path)])


LAUNCH_ARGV = ["--arch", "llama2-7b", "--tiny", "--steps", "3", "--batch",
               "4", "--seq", "16", "--accum", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def launch_root(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


@pytest.fixture(scope="module")
def started(weights, launch_root):
    """Every world of ranks (1, 2 and 4), the launcher at --mesh 2x2 and
    the reference's ``moe_layer_ep`` process, started at the same time
    (the reference's steps run meanwhile, :func:`reference`): their
    futures."""
    root = launch_root
    ep = _ep_inputs()
    jobs = {1: [], 2: [("mesh", "mesh", str(root / "ckpt_2x1"))], 4: []}
    for cell in CELLS:
        n = int(np.prod(cell.dims))
        jobs[n].append(("train", cell.name,
                        (cell, weights[cell.arch], _batches(cell))))
    for dims, fsdp in EP_CASES:
        jobs[dims[0] * dims[1]].append(("ep", (dims, fsdp), ep))
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        futs = {n: ex.submit(run_ranks, _world, n, backend="gloo",
                             workdir=str(root / str(n)), args=(jobs[n],),
                             timeout=300)
                for n in jobs}
        futs["launch"] = ex.submit(_launcher,
                                   LAUNCH_ARGV + ["--mesh", "2x2"],
                                   root / "launch_2x2")
        futs["ep_reference"] = ex.submit(_ep_reference, root)
        yield futs


@pytest.fixture(scope="module")
def worlds(started, reference):
    """ranks → {job key: each rank's result}; "launch" → the launcher's
    history (its checkpoint under ``launch_2x2`` of :func:`launch_root`);
    "ep_reference" → the reference's ``moe_layer_ep`` outputs."""
    return {n: f.result() for n, f in started.items()}


@pytest.fixture(scope="module")
def ep_reference(worlds):
    return worlds["ep_reference"]


@pytest.fixture(scope="module")
def reference(weights, started):
    """The reference's unsharded jitted step, STEPS steps from its init,
    per distinct (arch, rows, moe_groups): each step's metrics and the
    state after the steps, as numpy keyed as the port's parameters."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    from repro.training import optimizer as JO
    from repro.training import train_loop as JL
    from repro_torch.params import _flatten

    out = {}
    for cell in CELLS:
        key = _cell_key(cell)
        if key in out:
            continue
        jc = jax_config(cell.arch).tiny()
        params, state = JL.init_train_state(jc, jax.random.PRNGKey(0))
        opts = JT.RuntimeOpts(q_chunk=SEQ, kv_chunk=SEQ, remat=True,
                              moe_groups=cell.moe_groups)
        step = jax.jit(JL.make_train_step(jc, JL.TrainConfig(
            JO.AdamWConfig(**OPT), accum_steps=2), opts))
        metrics = []
        for b in _batches(cell):
            params, state, m = step(params, state,
                                    {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out[key] = {"metrics": metrics,
                    "params": {k: np.asarray(v)
                               for k, v in _flatten(params).items()},
                    "mu": {k: np.asarray(v)
                           for k, v in _flatten(state.mu).items()},
                    "nu": {k: np.asarray(v)
                           for k, v in _flatten(state.nu).items()}}
    return out


def _cell_result(worlds, cell) -> list:
    return [r[cell.name] for r in worlds[int(np.prod(cell.dims))]]


def param_atol(steps: int = STEPS) -> float:
    """2 · Σ lr_t over the steps (the module docstring)."""
    from repro_torch.training import optimizer as TO

    cfg = TO.AdamWConfig(**OPT)
    return 2 * sum(float(TO.lr_schedule(cfg, torch.tensor(t)))
                   for t in range(1, steps + 1))


def _hold_params(got: dict, want: dict, atol: float) -> None:
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= atol, diffs.max()
    assert np.mean(diffs > PARAM_TIGHT) <= PARAM_LOOSE_SHARE, \
        np.mean(diffs > PARAM_TIGHT)


# ------------------------------------------------------- (a) the rules


def _norm_entry(entry):
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _reference_specs(jcfg, mesh, fsdp) -> dict:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.launch import sharding as JS

    tree = JS.param_specs(jcfg, mesh, fsdp)
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {JS._path_str(path): tuple(_norm_entry(e) for e in spec)
            for path, spec in flat}


@pytest.fixture(scope="module")
def memo_abstract_params():
    """The reference's ``abstract_params`` memoized per config for this
    module (the rules call it for every mesh)."""
    from repro.models import transformer as JT

    original, memo = JT.abstract_params, {}

    def cached(cfg, *args):
        key = (cfg, args)
        if key not in memo:
            memo[key] = original(cfg, *args)
        return memo[key]

    JT.abstract_params = cached
    yield
    JT.abstract_params = original


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("arch", list_configs())
def test_placement_rules_match_reference(arch, size, memo_abstract_params):
    """``param_specs``, ``opt_state_specs`` and ``batch_specs`` against
    ``repro.launch.sharding`` on abstract meshes (no device is made; a
    full config's leaves are shapes only)."""
    from jax.sharding import AbstractMesh as JaxMesh

    from repro.configs import get_config as jax_config

    jcfg, cfg = jax_config(arch), get_config(arch)
    if size == "tiny":
        jcfg, cfg = jcfg.tiny(), cfg.tiny()
    from repro.launch import sharding as JS

    for dims in MESHES:
        names = ("data", "model") if len(dims) == 2 \
            else ("pod", "data", "model")
        jmesh, mesh = JaxMesh(dims, names), AbstractMesh(dims, names)
        for fsdp in (True, False):
            want = _reference_specs(jcfg, jmesh, fsdp)
            got = TS.param_specs(cfg, mesh, fsdp)
            assert set(got) == set(want), (dims, fsdp)
            for k, spec in got.items():
                w = want[k] + (None,) * (len(spec) - len(want[k]))
                assert spec == w, (k, dims, fsdp, spec, w)
        state = TS.opt_state_specs(got)
        assert state.mu is got and state.nu is got and state.count == ()
        for batch in (1, 2, 3, 4, 8, 12):
            assert TS.batch_specs(mesh, batch) == _norm_entry(
                JS.batch_specs(jmesh, batch)), (dims, batch)


def test_placement_rules_cases_named_in_the_rules():
    """Spot checks of the rules at (2, 4) with FSDP: the attention
    projections, the embedding, the (nb, D) norms over the data dims,
    the final norm; qwen3-moe's experts over ``model``, qwen2-moe's ffn
    dim; the pod dim joining data."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    s = TS.param_specs(get_config("llama2-7b").tiny(), mesh, True)
    assert s["blocks/p0/mixer/wq"] == (None, "data", "model")
    assert s["embed"] == ("model", "data")
    assert s["blocks/p0/ln1"] == ("data", "model")
    assert s["final_norm"] == (None,)
    q3 = TS.param_specs(get_config("qwen3-moe-235b-a22b").tiny(), mesh, True)
    assert q3["blocks/p0/ffn/w_gate"] == (None, "model", "data", None)
    q2 = TS.param_specs(get_config("qwen2-moe-a2.7b").tiny(), mesh, False)
    assert q2["blocks/p0/ffn/w_gate"] == (None, None, None, "model")
    pod = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    s3 = TS.param_specs(get_config("llama2-7b").tiny(), pod, True)
    assert s3["blocks/p0/mixer/wq"] == (None, ("pod", "data"), "model")
    assert TS.batch_specs(pod, 8) == ("pod", "data")
    assert TS.batch_specs(pod, 6) is None


# ---------------------------------------------- (b), (c) the train step


@pytest.mark.parametrize("cell", CELLS, ids=[c.name for c in CELLS])
def test_sharded_step_matches_reference(cell, worlds, reference):
    """Every rank's metrics each step (the same on every rank) against
    the reference's unsharded step, and the gathered parameters and
    moments after the steps (the module docstring's bars)."""
    ranks = _cell_result(worlds, cell)
    assert all(r["mesh"] == cell.dims for r in ranks)
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    ref = reference[_cell_key(cell)]
    for got, want in zip(ranks[0]["metrics"], ref["metrics"]):
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=METRIC_REL,
                                           abs=1e-7), (k, got, want)
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    if cell.arch != "llama2-7b":
        assert ranks[0]["metrics"][0]["aux"] > 0
    _hold_params(ranks[0]["params"], ref["params"], param_atol())
    for name in ("mu", "nu"):
        for k, w in ref[name].items():
            g = ranks[0][name][k]
            assert np.abs(g - w).max() <= MOMENT_REL * max(
                np.abs(w).max(), 1e-30), (name, k)


def test_one_rank_mesh_is_the_unsharded_step_bit_for_bit(worlds, weights):
    """At (1, 1) no collective runs: each step's metrics and the state
    after the steps are the port's unsharded step's, bit for bit."""
    from repro_torch.params import _to_tensor
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TL

    cell = CELLS[0]
    assert cell.dims == (1, 1)
    (got,) = _cell_result(worlds, cell)
    cfg = get_config(cell.arch).tiny()
    p = {k: _to_tensor(v) for k, v in weights[cell.arch].items()}
    s = TO.adamw_init(p)
    step = TL.make_train_step(cfg, TL.TrainConfig(
        TO.AdamWConfig(**OPT), accum_steps=2), _opts(cell))
    for b, m_got in zip(_batches(cell), got["metrics"]):
        p, s, m = step(p, s, {k: torch.from_numpy(v) for k, v in b.items()})
        assert {k: float(v) for k, v in m.items()} == m_got
    for name, tree in (("params", p), ("mu", s.mu), ("nu", s.nu)):
        assert all(np.array_equal(got[name][k], v.numpy())
                   for k, v in tree.items()), name


@pytest.mark.parametrize("cell", CELLS, ids=[c.name for c in CELLS])
def test_each_rank_stores_its_share(cell, worlds):
    """(e) Each rank's parameter bytes equal the rule's share of the
    whole; its two moments twice that (the step count aside)."""
    cfg = get_config(cell.arch).tiny()
    from repro_torch.params import param_specs as shapes

    whole = sum(4 * int(np.prod(v[0])) for v in shapes(cfg).values())
    ranks = _cell_result(worlds, cell)
    for r in ranks:
        res = r["resident"]
        assert res["params"] == res["share"]
        assert res["moments"] == 2 * res["share"]
    # the shares cover the whole at least once
    assert sum(r["resident"]["share"] for r in ranks) >= whole
    if int(np.prod(cell.dims)) > 1:
        assert ranks[0]["resident"]["share"] < whole


def test_training_mesh_refusals_and_round_trip(worlds):
    """A mesh whose product is not the world size, or of another length,
    raises ``ValueError``; shard then gather gives the leaves back
    exactly, and so does a sharded checkpoint (whole leaves on disk, each
    rank's blocks restored, the moments too); without a process group the
    mesh raises ``RuntimeError``."""
    from repro_torch.launch.mesh import make_training_mesh

    for r in worlds[2]:
        res = r["mesh"]
        assert "needs 4 ranks" in res[(2, 2)]
        assert "2 or 3" in res[(4,)] and "2 or 3" in res[(1, 1, 1, 2)]
        assert res["round_trip"]
        assert res["checkpoint"] and res["checkpoint_whole"]
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_training_mesh((1, 1))


# ------------------------------------------------ (d) moe_layer_ep


@pytest.mark.parametrize("dims,fsdp", EP_CASES,
                         ids=[f"{d[0]}x{d[1]}-fsdp{int(f)}"
                              for d, f in EP_CASES])
def test_moe_layer_ep_matches_reference(dims, fsdp, worlds, ep_reference):
    """Each data rank's rows of y and the aux against the reference's
    ``moe_layer_ep`` under a forced mesh; the aux is the mean of the
    ranks' own losses, not the grouped ``moe_layer``'s."""
    ranks = worlds[dims[0] * dims[1]]
    key = f"{dims[0]}x{dims[1]}_{int(fsdp)}"
    want_y, want_aux = ep_reference["y_" + key], ep_reference["aux_" + key]
    rows = want_y.shape[0] // dims[0]
    for r in ranks:
        res = r[(dims, fsdp)]
        i = res["index"]
        np.testing.assert_allclose(res["y"], want_y[i * rows:(i + 1) * rows],
                                   rtol=1e-5, atol=1e-5)
        assert res["aux"] == pytest.approx(float(want_aux), rel=1e-5)
    grouped = float(ep_reference[f"grouped_aux_{dims[0]}"])
    assert abs(float(want_aux) - grouped) > 1e-4


def test_moe_layer_ep_drops_pairs_per_rank(ep_reference):
    """The inputs make the capacity drop pairs: the per-rank dispatch's
    output differs from the grouped layer's only where both drop, and
    the reference's y at (2, 1) is the grouped layer's at groups 2."""
    np.testing.assert_allclose(ep_reference["y_2x1_1"],
                               ep_reference["grouped_y_2"], rtol=1e-5,
                               atol=1e-6)
    from repro_torch.models.moe import capacity

    spec = get_config("qwen2-moe-a2.7b").tiny().pattern[0].ffn
    tokens = EP_SHAPE[0] * EP_SHAPE[1] // 2
    assert capacity(tokens, spec, EP_CF) * spec.num_experts \
        < tokens * spec.top_k


def test_moe_layer_ep_refuses_without_a_process_group():
    from repro_torch.models.moe import moe_layer_ep

    with pytest.raises(RuntimeError, match="init_process_group"):
        moe_layer_ep({}, torch.zeros(1, 1, 4), None, ("data",))


# ---------------------------------------------------- (f) the launcher


def test_launcher_mesh_checkpoint_restores_in_the_reference(worlds,
                                                           launch_root):
    """``launch.train --mesh 2x2 --device cpu`` (4 gloo ranks): rank 0's
    history, a checkpoint the reference's ``restore_checkpoint`` reads
    into f32 leaves, equal to the unsharded launcher's within
    ``param_atol`` of the launcher's schedule."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    from repro.training import checkpoint as JC
    from repro_torch.params import _flatten
    from repro_torch.training import optimizer as TO

    got = worlds["launch"]
    want = _launcher(LAUNCH_ARGV, launch_root / "launch_1x1")
    assert len(got) == 3 == len(want)
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=METRIC_REL)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"],
                                               rel=METRIC_REL)
    jc = jax_config("llama2-7b").tiny()
    template = jax.tree_util.tree_map(
        jnp.zeros_like, JT.init_params(jc, jax.random.PRNGKey(0)))
    restored, step = JC.restore_checkpoint(str(launch_root / "launch_2x2"),
                                           template)
    with np.load(launch_root / "launch_1x1" / "arrays.npz") as a:
        unsharded = {k: a[k] for k in a.files}
    assert step == 3
    flat = {k: np.asarray(v) for k, v in _flatten(restored).items()}
    assert all(v.dtype == np.float32 for v in flat.values())
    cfg = TO.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3)
    atol = 2 * sum(float(TO.lr_schedule(cfg, torch.tensor(t)))
                   for t in range(1, 4))
    _hold_params(flat, unsharded, atol)


def test_launcher_refuses_nccl_without_a_card_a_rank():
    with pytest.raises(ValueError, match="--backend gloo"):
        train_launcher.main(LAUNCH_ARGV + ["--mesh", "2x1", "--backend",
                                           "nccl"])


class _Joined(Exception):
    """Raised by a stand-in ``init_process_group``: the rank got that far."""


@pytest.mark.parametrize("local_world,joins", [(8, True), (9, False)])
def test_launcher_under_torchrun_counts_this_hosts_ranks(
        monkeypatch, local_world, joins):
    """Under torchrun over two hosts of 8 cards (``WORLD_SIZE`` 16 at
    ``--mesh 2x4x2``), nccl checks this host's ranks (``LOCAL_WORLD_SIZE``)
    against its cards, not the world, and the rank takes card
    ``LOCAL_RANK``, not its global rank."""
    import torch.distributed as dist

    env = {"WORLD_SIZE": "16", "RANK": "13", "LOCAL_RANK": "5",
           "LOCAL_WORLD_SIZE": str(local_world)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    joined = []

    def init(backend, *args, **kwargs):
        joined.append(backend)
        raise _Joined

    monkeypatch.setattr(dist, "init_process_group", init)
    argv = ["--arch", "llama2-7b", "--tiny", "--mesh", "2x4x2",
            "--device", "cuda", "--backend", "nccl"]
    if joins:
        with pytest.raises(_Joined):
            train_launcher.main(argv)
        assert joined == ["nccl"]
    else:
        with pytest.raises(ValueError, match="9 ranks on this host's 8"):
            train_launcher.main(argv)
        assert joined == []
    args = train_launcher.argparse.Namespace(device=None, backend="nccl")
    assert train_launcher._rank_device(args, 5) == torch.device("cuda", 5)


# ---------------------------------------------------------- card tests


def _card_rank(rank, world, device_names) -> dict:
    """llama2-7b tiny over one NCCL rank per card: 3 sharded steps, each
    step's metrics and the state's bytes after each."""
    import hashlib

    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.params import init_params
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TL

    device = torch.device(device_names[rank])
    torch.cuda.set_device(device)
    cfg = get_config("llama2-7b").tiny()
    cell = Cell("card", (world, 1), "llama2-7b")
    mesh = make_training_mesh(cell.dims)
    p = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                    device=device)
    s = TO.adamw_init(p)
    place = TS.TrainPlacement(cfg, mesh)
    p, s = place.shard(p), place.shard(s)
    step = TL.make_train_step(cfg, TL.TrainConfig(
        TO.AdamWConfig(**OPT), accum_steps=2), _opts(cell), mesh=mesh)
    out = []
    for b in _batches(cell):
        p, s, m = step(p, s, {k: torch.from_numpy(v).to(device)
                              for k, v in b.items()})
        whole = place.whole(p)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "digest": {k: hashlib.sha256(v.cpu().numpy().tobytes())
                               .hexdigest() for k, v in whole.items()}})
    return out


def _unsharded_on_card(device) -> list:
    import hashlib

    from repro_torch.params import init_params
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TL

    cfg = get_config("llama2-7b").tiny()
    cell = Cell("card", (1, 1), "llama2-7b")
    p = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                    device=device)
    s = TO.adamw_init(p)
    step = TL.make_train_step(cfg, TL.TrainConfig(
        TO.AdamWConfig(**OPT), accum_steps=2), _opts(cell))
    out = []
    for b in _batches(cell):
        p, s, m = step(p, s, {k: torch.from_numpy(v).to(device)
                              for k, v in b.items()})
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "digest": {k: hashlib.sha256(v.cpu().numpy().tobytes())
                               .hexdigest() for k, v in p.items()}})
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL ranks run one a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_nccl_rank_is_the_unsharded_step_bit_for_bit(cuda_device,
                                                        tmp_path):
    """One NCCL rank on the (1, 1) mesh: every step's metrics and every
    parameter's SHA-256 after each step equal the unsharded step's on the
    same card."""
    (got,) = run_ranks(_card_rank, 1, backend="nccl",
                       workdir=str(tmp_path), args=(["cuda:0"],),
                       timeout=600)
    assert got == _unsharded_on_card(cuda_device)


@pytest.mark.cuda
def test_nccl_ranks_on_two_cards(cuda_device, tmp_path):
    """Two NCCL ranks, one a card, on the (2, 1) mesh: every rank's
    metrics equal, and within ``METRIC_REL`` of the unsharded step's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card: NCCL takes one rank a card")
    ranks = run_ranks(_card_rank, 2, backend="nccl", workdir=str(tmp_path),
                      args=(["cuda:0", "cuda:1"],), timeout=600)
    want = _unsharded_on_card(cuda_device)
    assert [s["metrics"] for s in ranks[0]] == \
        [s["metrics"] for s in ranks[1]]
    for got, w in zip(ranks[0], want):
        for k in ("loss", "ce", "grad_norm"):
            assert got["metrics"][k] == pytest.approx(w["metrics"][k],
                                                      rel=METRIC_REL)

"""The data mesh in the port: ``mesh_axes=`` through the reduction engine
and the optimizer, and ``launch.steps.make_mesh_guarded_train_step``, on
CPU ranks under gloo, against the reference on forced host devices.

The reference runs in one subprocess for the file (8 forced host devices,
as ``tests/test_distributed_reduce.py`` runs it); the port's ranks in one
``torch.multiprocessing.spawn`` per world size, 1, 2, 4 and 8
(``tests/torch_mesh_workers.py``), on the same numpy inputs:

  * ``reduce`` (sum, sumsq, norm2, mean, moments), ``reduce_many`` and
    ``reduce(census=True)`` with ``mesh_axes=``, the cases of the
    reference's ``test_scalar_and_many_replica_invariant_and_correct``, on
    cuda_fused (its plain versions on the CPU) and mma_torch against the
    reference's pallas_fused and mma_jnp at P = 8: within
    ``harness.budget_for`` of each statistic at the plan's multipliers (the
    reference's own test holds them at 3e-3 relative to numpy);
  * ``reduce_tree(census=True, mesh_axes=)``, the reference's
    ``test_reduce_tree_census_bitwise_across_device_counts`` inputs (a NaN
    planted in one leaf), at worlds 1, 2, 4 and 8 on cuda_fused and torch:
    census counts exact and the norm's bits the same at every world, as
    the reference's; the clean leaf's per-leaf slot within 1e-6 relative
    of numpy's (f32 sums of the same squares in other orders);
  * the lockstep scenario of ``test_guarded_step_lockstep_skip_and_rollback``
    at 8 ranks: skip flags and census totals exact, grad norm and clip 1e-6
    relative, rollback at step 5 on every rank, as in the reference;
  * the data-mesh guarded step of tiny olmo-1b at world 2, three steps
    (clean, rank 1's shard poisoned, clean) against the reference's
    ``make_mesh_guarded_train_step`` on 2 host devices: the tolerances of
    ``tests/test_torch_train.py``'s two-step parity test, for the same
    reasons: loss 1e-3 (K1 rounds each token's loss to bf16 in both),
    grad norm and clip 1e-4 relative (the same f32 math in other orders),
    parameters within 2 lr x step with all but 0.1% within 1e-5 (plain
    AdamW moves a weight by about lr x sign(g) on its first steps).

Contracts inside the port, each with a planted fault that must fail it:
every rank holds the same bits; two runs give the same bits; the census
path's bits are the same at worlds 1, 2, 4 and 8; a clean mesh step at
world 1 equals ``make_guarded_train_step`` bitwise.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from harness import budget_for
from repro.configs import get_arch as ref_arch
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import init_params as ref_init_params
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.models.convert import params_from_jax

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLDS = (1, 2, 4, 8)
BACKENDS = {"cuda_fused": "pallas_fused", "mma_torch": "mma_jnp"}
TREE_BACKENDS = {"cuda_fused": "pallas_fused", "torch": "xla"}
STEP_BATCH, STEP_SEQ, STEP_WORLD = 4, 16, 2
STEP_SCALES = (None, np.array([1.0, np.nan], np.float32), None)


def _reduce_inputs():
    x = (np.arange(8 * 250, dtype=np.float32) / 17.0).reshape(8, 250) - 50.0
    w = np.arange(8 * 32, dtype=np.float32).reshape(8, 32) / 7.1
    b = (np.arange(8 * 4, dtype=np.float32) / 3.3).reshape(8, 4)
    b[3, 2] = np.nan  # lands in one rank's shard at every world size
    return x, {"b": b, "w": w}


def _lockstep_inputs():
    rng = np.random.RandomState(0)
    w = rng.randn(8, 16).astype(np.float32)
    b = np.linspace(-1.0, 1.0, 8, dtype=np.float32)
    base_w = rng.randn(8, 16).astype(np.float32) * np.float32(0.1)
    base_b = rng.randn(8).astype(np.float32) * np.float32(0.1)
    return w, b, base_w, base_b


def _step_tokens():
    cfg = get_arch("olmo-1b", tiny=True)
    data = RefSyntheticLM(cfg.vocab_size, STEP_SEQ, STEP_BATCH, seed=0)
    return [data.next()["tokens"] for _ in STEP_SCALES]


def _ref_cfg():
    return dataclasses.replace(ref_arch("olmo-1b", tiny=True), use_pallas=True)


REF = """
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import optim
from repro import reduce as R
from repro.configs import TrainConfig, get_arch
from repro.core import collectives as C
from repro.launch.steps import make_mesh_guarded_train_step
from repro.models import init_params
from repro.optim.adamw import AdamWState
from repro.runtime import ChaosMonkey, StepGuard

inp = dict(np.load(sys.argv[1], allow_pickle=True))
out = {}
x = inp["x"]
arrs = [jnp.asarray(x[:, :40]), jnp.asarray(x[:, 40:47])]

def scalar_row(p, backend):
    mesh = jax.make_mesh((p,), ("data",))
    def body(v, a0, a1):
        outs = [R.reduce(v, kind=k, backend=backend, mesh_axes=("data",))
                for k in ("sum", "sumsq", "norm2", "mean")]
        mu, var = R.reduce(v, kind="moments", backend=backend, mesh_axes=("data",))
        many = R.reduce_many([a0, a1], kind="sumsq", backend=backend, mesh_axes=("data",))
        return jnp.concatenate([jnp.stack(outs + [mu, var]), many])[None, :]
    f = jax.jit(C.shard_map_unchecked(body, mesh=Mesh(np.array(jax.devices()[:p]), ("data",)),
                                      in_specs=(P("data"),) * 3, out_specs=P("data")))
    return np.asarray(f(jnp.asarray(x), *arrs))

for backend in ("pallas_fused", "mma_jnp"):
    for p in (1, 8):
        out[f"scalar_{backend}_{p}"] = scalar_row(p, backend)

tree = {"b": jnp.asarray(inp["b"]), "w": jnp.asarray(inp["w"])}
for backend in ("pallas_fused", "xla"):
    for p in (1, 2, 4, 8):
        def body(t, backend=backend):
            norm, counts = R.reduce_tree(t, "norm2", backend=backend, census=True,
                                         mesh_axes=("data",))
            return norm[None], counts[None, :]
        f = jax.jit(C.shard_map_unchecked(
            body, mesh=Mesh(np.array(jax.devices()[:p]), ("data",)), in_specs=(P("data"),),
            out_specs=(P("data"), P("data"))))
        norms, counts = f(tree)
        out[f"tree_{backend}_{p}"] = np.asarray(norms)[0]
        out[f"counts_{backend}_{p}"] = np.asarray(counts)[0]

# the lockstep scenario
mesh = jax.make_mesh((8,), ("data",))
tcfg = TrainConfig(learning_rate=1e-2, total_steps=20, warmup_steps=1)
params = {"w": jnp.asarray(inp["lw"]), "b": jnp.asarray(inp["lb"])}
state = optim.init_state(params)
guard = optim.init_guard_state(8)
pspec = {"w": P("data"), "b": P("data")}
sspec = AdamWState(step=P(), m=pspec, v=pspec)
gspec = jax.tree.map(lambda _: P(), guard)
def gbody(p, g, s, gu, lo):
    new_p, new_s, new_gu, m = optim.guarded_apply_updates(
        p, g, s, tcfg, loss=lo, guard=gu, reduce_backend="pallas_fused", mesh_axes=("data",))
    return new_p, new_s, new_gu, {k: v[None] for k, v in m.items()}
step_fn = jax.jit(C.shard_map_unchecked(gbody, mesh=mesh,
                                        in_specs=(pspec, pspec, sspec, gspec, P()),
                                        out_specs=(pspec, sspec, gspec, P("data"))))
monkey = ChaosMonkey(nan_steps=(3, 4, 5), host=2)
guards = [StepGuard(max_bad_steps=3, sleep=lambda s: None) for _ in range(8)]
rollback_at = [None] * 8
for t in range(1, 9):
    grads = {"w": monkey.corrupt_shard(jnp.asarray(inp["base_w"]), t, shards=8),
             "b": jnp.asarray(inp["base_b"])}
    params, state, guard, m = step_fn(params, grads, state, guard, jnp.float32(1.0))
    for k in ("skipped", "grad_norm", "nonfinite", "clip"):
        out[f"lock_{k}_{t}"] = np.asarray(m[k])
    for h in range(8):
        guards[h].record(float(np.asarray(m["skipped"])[h]) > 0.0)
        if rollback_at[h] is None and guards[h].should_rollback():
            rollback_at[h] = t
out["lock_rollback_at"] = np.array([-1 if r is None else r for r in rollback_at])
out["lock_w"], out["lock_b"] = np.asarray(params["w"]), np.asarray(params["b"])

# the data-mesh guarded step of tiny olmo-1b on 2 host devices, every
# reduction on the kernels (the port's ranks run cuda_fused)
R.set_default_backend("pallas_fused")
cfg = dataclasses.replace(get_arch("olmo-1b", tiny=True), use_pallas=True)
scales = inp["scales"]
tcfg = TrainConfig(total_steps=len(scales), warmup_steps=1)
params, _ = init_params(jax.random.PRNGKey(0), cfg)
opt = optim.init_state(params)
guard = optim.init_guard_state(16)
step = make_mesh_guarded_train_step(cfg, tcfg, Mesh(np.array(jax.devices()[:2]), ("data",)),
                                    reduce_backend="pallas_fused")
for i, (tok, sc) in enumerate(zip(inp["tokens"], scales)):
    batch = {"tokens": jnp.asarray(tok)}
    if sc is not None:
        batch["chaos_scale"] = jnp.asarray(sc)
    params, opt, guard, m = step(params, opt, guard, batch)
    for k in ("loss", "grad_norm", "clip", "skipped", "nonfinite"):
        out[f"step_{k}_{i}"] = np.asarray(m[k])
for i, leaf in enumerate(jax.tree.leaves(params)):
    out[f"step_param_{i}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    x, tree = _reduce_inputs()
    lw, lb, base_w, base_b = _lockstep_inputs()
    scales = np.empty(len(STEP_SCALES), dtype=object)
    scales[:] = list(STEP_SCALES)
    np.savez(d / "in.npz", x=x, b=tree["b"], w=tree["w"], lw=lw, lb=lb, base_w=base_w,
             base_b=base_b, tokens=np.stack(_step_tokens()), scales=scales)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF), str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True, env=env,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), _ref_cfg())
    path = tmp_path_factory.mktemp("params") / "params.pt"
    torch.save(params_from_jax(jax.tree.map(np.asarray, rparams), get_arch("olmo-1b", tiny=True)),
               path)
    return str(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, params_path):
    """Every world's ranks, one spawn a world: {world: [rank results]}."""
    x, tree = _reduce_inputs()
    reduce_args = (x, tree, tuple(BACKENDS), tuple(TREE_BACKENDS))
    tokens = _step_tokens()
    todo = {1: [("mesh_reduce", reduce_args),
                ("mesh_step_world1_bitwise", (params_path, tokens, "cuda_fused"))],
            2: [("mesh_reduce", reduce_args), ("meshes", ()),
                ("mesh_step", (params_path, tokens, list(STEP_SCALES), "cuda_fused"))],
            4: [("mesh_reduce", reduce_args)],
            8: [("mesh_reduce", reduce_args), ("lockstep", _lockstep_inputs() + (8,))]}
    return {world: W.run("calls", world, tmp_path_factory.mktemp(f"world{world}"), calls)
            for world, calls in todo.items()}


def _bits(t):
    return t.detach().contiguous().numpy().tobytes()


def _replicated(results, key):
    """The bits every rank holds of ``key``; asserts they are the same."""
    bits = [key(r) for r in results]
    assert bits == bits[:1] * len(bits)
    return bits[0]


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("world", WORLDS)
def test_reduce_and_many_against_reference(ref, ranks, backend, world):
    x, _ = _reduce_inputs()
    rows = [r["mesh_reduce"][backend] for r in ranks[world]]
    # every rank the same bits, and a second run the same bits again
    _replicated(rows, lambda runs: _bits(runs[0]))
    assert all(_bits(runs[0]) == _bits(runs[1]) for runs in rows)
    got = rows[0][0].numpy()
    want = ref[f"scalar_{BACKENDS[backend]}_8"][0]
    compute = {"sum": "bfloat16", "sumsq": "float32", "norm2": "float32", "mean": "bfloat16"}
    a, b = x[:, :40], x[:, 40:47]
    for i, (kind, data) in enumerate([("sum", x), ("sumsq", x), ("norm2", x), ("mean", x),
                                      ("sum", x), ("sum", x), ("sumsq", a), ("sumsq", b)]):
        if i == 5:  # the moments' sumsq: squares at bf16 multipliers
            kind, comp = "sumsq", "bfloat16"
        else:
            comp = compute[kind]
        tol = budget_for(data, kind, compute_dtype=comp)
        assert abs(float(got[i]) - float(want[i])) <= 2 * tol, (i, got[i], want[i])
    # reduce_many's mean over the global count, and the census count (0)
    for i, arr in ((8, a), (9, b)):
        assert abs(float(got[i]) - arr.astype(np.float64).mean()) <= 2 * budget_for(
            arr, "mean", compute_dtype="bfloat16")
    assert got[11] == 0.0
    assert abs(float(got[10]) - np.sqrt((x.astype(np.float64) ** 2).sum())) <= budget_for(
        x, "norm2", compute_dtype="float32")


@pytest.mark.parametrize("backend", list(TREE_BACKENDS))
def test_census_path_bitwise_across_worlds_and_against_reference(ref, ranks, backend):
    bits = []
    for world in WORLDS:
        res = [r["mesh_reduce"][f"tree_{backend}"] for r in ranks[world]]
        norm = _replicated(res, lambda t: _bits(t["norm"]))
        _replicated(res, lambda t: _bits(t["counts"]) + _bits(t["counts2"]) + _bits(t["fork"])
                    + _bits(t["per"]))
        # census: leaf order (b, w) -> [1 NaN, 0, total 1], as the reference's
        np.testing.assert_array_equal(res[0]["counts"].numpy(), [1.0, 0.0, 1.0])
        np.testing.assert_array_equal(ref[f"counts_{TREE_BACKENDS[backend]}_{world}"],
                                      [1.0, 0.0, 1.0])
        assert np.isnan(res[0]["norm"].item()) and np.isnan(
            ref[f"tree_{TREE_BACKENDS[backend]}_{world}"])
        bits.append(norm)
    assert bits == bits[:1] * len(WORLDS)


@pytest.mark.parametrize("backend", list(TREE_BACKENDS))
def test_census_path_per_leaf_sums(ranks, backend):
    """The census path's per-leaf slots: NaN for the poisoned leaf, and the
    clean leaf's sum of squares within 1e-6 relative of numpy's at every
    world (f32 sums of the same squares in other orders)."""
    _, tree = _reduce_inputs()
    want = (tree["w"].astype(np.float64) ** 2).sum()
    for world in WORLDS:
        per = ranks[world][0]["mesh_reduce"][f"tree_{backend}"]["per"].numpy()
        assert np.isnan(per[0])
        assert abs(float(per[1]) - want) <= 1e-6 * want


def test_lockstep_skip_and_rollback_against_reference(ref, ranks):
    res = [r["lockstep"] for r in ranks[8]]
    for t in range(1, 9):
        for k in ("skipped", "nonfinite", "grad_norm", "clip"):
            vals = [float(r["steps"][t - 1][k]) for r in res]
            want = float(ref[f"lock_{k}_{t}"][0])
            assert _bits(torch.tensor(vals)) == _bits(torch.tensor(vals[:1] * 8)), (t, k)
            if k in ("skipped", "nonfinite"):
                assert vals[0] == want, (t, k)
            elif np.isnan(want):
                assert np.isnan(vals[0])
            else:
                assert vals[0] == pytest.approx(want, rel=1e-6), (t, k)
        skipped = t in (3, 4, 5)
        assert (float(res[0]["steps"][t - 1]["skipped"]) > 0) == skipped
        if skipped:  # parameters pass through bitwise on every rank
            assert all(r["steps"][t - 1]["unchanged"] for r in res)
    assert [r["rollback_at"] for r in res] == [5] * 8 == list(ref["lock_rollback_at"])
    w = np.concatenate([r["params"]["w"].numpy() for r in res])
    np.testing.assert_allclose(w, ref["lock_w"], rtol=0, atol=1e-6)


def test_mesh_step_against_reference(ref, ranks):
    res = [r["mesh_step"] for r in ranks[STEP_WORLD]]
    for i, scale in enumerate(STEP_SCALES):
        for k in ("loss", "grad_norm", "clip", "skipped", "nonfinite"):
            _replicated(res, lambda r: _bits(r["metrics"][i][k]))
        m = res[0]["metrics"][i]
        assert abs(float(m["loss"]) - float(ref[f"step_loss_{i}"])) <= 1e-3
        poisoned = scale is not None
        assert float(m["skipped"]) == float(ref[f"step_skipped_{i}"]) == float(poisoned)
        assert (float(m["nonfinite"]) > 0) == (float(ref[f"step_nonfinite_{i}"]) > 0) == poisoned
        if not poisoned:
            for k in ("grad_norm", "clip"):
                assert float(m[k]) == pytest.approx(float(ref[f"step_{k}_{i}"]), rel=1e-4), k
    _replicated(res, lambda r: b"".join(_bits(p) for p in r["params"]))
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), _ref_cfg())
    leaves, treedef = jax.tree.flatten(jax.tree.map(np.asarray, rparams))
    final = jax.tree.unflatten(treedef, [ref[f"step_param_{i}"] for i in range(len(leaves))])
    from repro_torch import reduce as R

    want = R.tree_leaves(params_from_jax(final, get_arch("olmo-1b", tiny=True)))
    diffs = torch.cat([(w - g).abs().reshape(-1) for w, g in zip(want, res[0]["params"])])
    lr, steps = TrainConfig().learning_rate, len(STEP_SCALES)
    assert float(diffs.max()) <= 2 * lr * steps
    assert int((diffs > 1e-5).sum()) <= 1e-3 * diffs.numel()


def test_mesh_step_combine_bytes_are_the_metered_bytes(ranks):
    """The step's ``combine_bytes`` (``interconnect_bytes`` of the gathered
    gradients and loss) equals what the meter saw its all-gathers bring
    into each rank, on clean and poisoned steps alike."""
    for r in ranks[STEP_WORLD]:
        for m in r["mesh_step"]["metrics"]:
            assert m["recv_bytes"] == m["combine_bytes"] > 0


def test_mesh_step_at_world_one_is_the_guarded_step_bitwise(ranks):
    (mesh_run, plain_run), = [r["mesh_step_world1_bitwise"] for r in ranks[1]]
    for key in ("losses", "params", "m", "v"):
        assert [_bits(t) for t in mesh_run[key]] == [_bits(t) for t in plain_run[key]], key
    # a planted fault fails the check: one ulp on one parameter
    wrong = [t.clone() for t in mesh_run["params"]]
    wrong[0].view(-1)[0] = torch.nextafter(wrong[0].view(-1)[0], torch.tensor(np.inf))
    assert [_bits(t) for t in wrong] != [_bits(t) for t in plain_run["params"]]


def test_planted_fault_fails_the_replication_check(ranks):
    """A rank whose result is one ulp off fails ``_replicated``."""
    rows = [r["mesh_reduce"]["cuda_fused"][0].clone() for r in ranks[2]]
    rows[1][0] = torch.nextafter(rows[1][0], torch.tensor(np.inf))
    with pytest.raises(AssertionError):
        _replicated(rows, _bits)


def test_mesh_axes_refusals():
    from repro_torch import reduce as R
    from repro_torch.core import collectives as C

    x = torch.ones(8, 4)
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        R.reduce(x, mesh_axes="data")
    mesh = C.Mesh(shape=(1,), axis_names=("data",), rank=0, groups={"data": None},
                  backend="gloo", device=torch.device("cpu"))
    with C.bound_mesh(mesh):
        with pytest.raises(ValueError, match="FULL reductions"):
            R.reduce(x, axis=-1, mesh_axes="data")
        with pytest.raises(ValueError, match="FULL per-array"):
            R.reduce_many([x], axis=-1, mesh_axes="data")
        with pytest.raises(ValueError, match="unbound axis"):
            R.reduce(x, mesh_axes="model")
        with pytest.raises(RuntimeError, match="not differentiable"):
            R.reduce_tree([x.requires_grad_(True)], mesh_axes="data")
        # a one-rank mesh gathers its own row: the single-rank value, bitwise
        y = torch.arange(32.0).reshape(8, 4)
        assert _bits(R.reduce(y, kind="norm2", mesh_axes="data")) == _bits(
            R.reduce(y, kind="norm2"))


def test_host_mesh_and_batch_axes(ranks):
    """The reference's ``make_host_mesh`` shape (1, n) over ("data",
    "model"), its one-rank "data" axis without a group, ``batch_axes``, and
    a combine over both axes summing every rank's row."""
    for r in ranks[2]:
        m = r["meshes"]
        assert m["shape"] == (1, 2) and m["axes"] == ("data", "model") and m["data_group"]
        assert m["batch"] == ("data",) and m["data_batch"] == ("data",)
        assert m["total"] == 3.0 and m["world"] == 2

"""Guarded training in the port: ``optim.guarded_apply_updates``, the chaos
and retry policy (``runtime.chaos``), the fault-tolerance runtime
(``runtime.fault_tolerance``), the guarded train step and the training
CLI's ``--guard`` / ``--chaos`` / ``--ckpt-dir`` loop.

  * ``guarded_apply_updates`` against the reference's on the same
    gradients, step by step (clean, NaN-, Inf-poisoned and loss-spike
    steps): skip flag, census total, ``GuardState`` and parameters. The
    update is f32 arithmetic on both sides: parameters within 1e-6
    (observed 0 to 1 ulp); flags, counts and the guard window exact.
  * The two bitwise contracts inside the port, with ``fused_second_moment``
    on and off: a clean guarded step equals ``apply_updates``; a poisoned
    step leaves parameters (bf16 bits, NaN payloads and -0.0 included),
    moments and ``step`` unchanged. The same through the guarded train
    step on tiny olmo, and its ``chaos_scale`` hook.
  * The loss-spike window; ``StepGuard`` retry and backoff; ``ChaosMonkey``
    firing once per step and its schedule equal to the reference's;
    ``TrainSupervisor`` rollback, anchor and mid-skip-streak cases of
    ``tests/test_chaos.py``; resume after an in-flight save; the other
    pieces of ``fault_tolerance`` against the reference's.
  * ``train.main`` on the CPU with the guard, chaos and checkpoints: a
    rollback that replays the same losses bitwise, finite losses.
"""

import signal
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro.runtime import ChaosMonkey as RefChaosMonkey
from repro.runtime import ElasticPlan as RefElasticPlan
from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.runtime import (
    ChaosMonkey,
    ElasticPlan,
    HeartbeatTracker,
    PreemptionGuard,
    StepGuard,
    TrainSupervisor,
    TransientFault,
)

_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t):
    return t.detach().reshape(-1).view(_INT[t.element_size()]).clone()


def _same_bits(a, b):
    la, lb = R.tree_leaves(a), R.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def _state_leaves(state):
    return [state.step] + list(state.m) + list(state.v)


def _params(dtype=torch.float32):
    return {"w": torch.full((40, 64), 0.5, dtype=dtype),
            "b": torch.linspace(-1, 1, 300, dtype=torch.float32)}


def _grads(bad=None, scale=0.01):
    g = np.full((40, 64), scale, np.float32)
    if bad is not None:
        g[11, 3] = bad
    return {"w": g, "b": np.linspace(-scale, scale, 300).astype(np.float32)}


# ----------------- guarded_apply_updates against the reference ---------------

BACKENDS = [("torch", "xla"), ("cuda_fused", "pallas_fused")]


@pytest.mark.parametrize("backend,ref_backend", BACKENDS, ids=["torch", "cuda_fused"])
@pytest.mark.parametrize("fused", [False, True], ids=["adamw", "fused-second-moment"])
def test_guarded_updates_match_reference(backend, ref_backend, fused):
    tcfg = TrainConfig(total_steps=20, warmup_steps=1)
    # (bad element or None, loss) per step; the window of 4 fills at step 4,
    # step 6's loss of 50 is a spike, steps 2 and 7 are poisoned
    plan = [(None, 1.0), (None, 1.01), (np.nan, 1.02), (None, 1.03), (None, 0.99),
            (None, 1.02), (None, 50.0), (np.inf, 1.0), (-np.inf, 1.0), (None, 1.01)]
    pp = _params()
    # copies: the port updates in place, and jnp.asarray may share a numpy buffer
    rp = {k: jnp.asarray(v.numpy().copy()) for k, v in pp.items()}
    ps = optim.init_state(pp, fused_second_moment=fused)
    rs = RO.init_state(rp, fused_second_moment=fused)
    pg, rg = optim.init_guard_state(4), RO.init_guard_state(4)
    for i, (bad, loss) in enumerate(plan):
        g = _grads(bad, scale=0.01 * (1 + i % 3))
        pp, ps, pg, pm = optim.guarded_apply_updates(
            pp, {k: torch.from_numpy(v) for k, v in g.items()}, ps, tcfg,
            loss=torch.tensor(loss), guard=pg, reduce_backend=backend,
            fused_second_moment=fused)
        rp, rs, rg, rm = RO.guarded_apply_updates(
            rp, {k: jnp.asarray(v) for k, v in g.items()}, rs, tcfg, loss=jnp.float32(loss),
            guard=rg, reduce_backend=ref_backend, fused_second_moment=fused)
        for key in ("skipped", "spike", "nonfinite"):
            assert float(pm[key]) == float(rm[key]), (i, key)
        assert float(pm["skipped"]) == (1.0 if bad is not None or loss == 50.0 else 0.0)
        assert int(pg.filled) == int(rg.filled) and int(pg.skipped) == int(rg.skipped)
        np.testing.assert_array_equal(pg.window.numpy(), np.asarray(rg.window))
        assert int(ps.step) == int(rs.step)
        for k in ("w", "b"):
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]), rtol=0, atol=1e-6)
    assert int(pg.skipped) == 4


@pytest.mark.parametrize("fused", [False, True], ids=["adamw", "fused-second-moment"])
@pytest.mark.parametrize("backend", ["torch", "mma_torch", "cuda_fused"])
def test_clean_guarded_step_equals_apply_updates_bitwise(fused, backend):
    tcfg = TrainConfig(total_steps=10, warmup_steps=1)
    plain_p, guard_p = _params(torch.bfloat16), _params(torch.bfloat16)
    plain_s = optim.init_state(plain_p, fused_second_moment=fused)
    guard_s = optim.init_state(guard_p, fused_second_moment=fused)
    guard = optim.init_guard_state(8)
    for i in range(3):
        g = {k: torch.from_numpy(v) for k, v in _grads(scale=0.01 * (i + 1)).items()}
        plain_p, plain_s, _ = optim.apply_updates(plain_p, g, plain_s, tcfg,
                                                  reduce_backend=backend,
                                                  fused_second_moment=fused)
        guard_p, guard_s, guard, m = optim.guarded_apply_updates(
            guard_p, g, guard_s, tcfg, loss=torch.tensor(1.0), guard=guard,
            reduce_backend=backend, fused_second_moment=fused)
        assert float(m["skipped"]) == 0.0 and float(m["nonfinite"]) == 0.0
        assert _same_bits(guard_p, plain_p)
        assert _same_bits(_state_leaves(guard_s), _state_leaves(plain_s))
    assert int(guard.filled) == 3 and int(guard.skipped) == 0


@pytest.mark.parametrize("fused", [False, True], ids=["adamw", "fused-second-moment"])
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf], ids=["nan", "inf", "-inf"])
def test_poisoned_step_passes_everything_through_bitwise(bad, fused):
    tcfg = TrainConfig(total_steps=10, warmup_steps=1)
    params = _params(torch.bfloat16)
    wbits = params["w"].view(torch.int16)
    wbits[0, 0] = 0x7FC3   # a NaN payload
    wbits[0, 1] = -0x8000  # -0.0
    state = optim.init_state(params, fused_second_moment=fused)
    g0 = {k: torch.from_numpy(v) for k, v in _grads().items()}
    params, state, _ = optim.apply_updates(params, g0, state, tcfg, reduce_backend="cuda_fused",
                                           fused_second_moment=fused)
    state.m[1].view(torch.int32)[0, 0] = -0x80000000  # -0.0 in a moment
    before_p = [t.clone() for t in R.tree_leaves(params)]
    before_s = [t.clone() for t in _state_leaves(state)]
    guard0 = optim.init_guard_state(8)
    g = {k: torch.from_numpy(v) for k, v in _grads(bad).items()}
    params, new_state, guard, m = optim.guarded_apply_updates(
        params, g, state, tcfg, loss=torch.tensor(1.0), guard=guard0,
        reduce_backend="cuda_fused", fused_second_moment=fused)
    assert float(m["skipped"]) == 1.0 and float(m["nonfinite"]) == 1.0
    assert _same_bits(R.tree_leaves(params), before_p)
    assert _same_bits(_state_leaves(new_state), before_s)
    assert int(guard.skipped) == 1 and int(guard.filled) == 0
    assert _same_bits(guard.window, guard0.window)


def test_loss_spike_forces_skip_and_recovers():
    tcfg = TrainConfig()
    params = _params()
    g = {k: torch.from_numpy(v) for k, v in _grads().items()}
    state = optim.init_state(params)
    guard = optim.init_guard_state(8)
    for i in range(8):
        params, state, guard, m = optim.guarded_apply_updates(
            params, g, state, tcfg, loss=torch.tensor(1.0 + 0.01 * i), guard=guard,
            reduce_backend="torch")
        assert float(m["skipped"]) == 0.0
    assert int(guard.filled) == 8
    before_p = [t.clone() for t in R.tree_leaves(params)]
    before_s = [t.clone() for t in _state_leaves(state)]
    params, state, guard, m = optim.guarded_apply_updates(
        params, g, state, tcfg, loss=torch.tensor(50.0), guard=guard, reduce_backend="torch")
    assert float(m["spike"]) == 1.0 and float(m["skipped"]) == 1.0
    assert _same_bits(R.tree_leaves(params), before_p)
    assert _same_bits(_state_leaves(state), before_s)
    params, state, guard, m = optim.guarded_apply_updates(
        params, g, state, tcfg, loss=torch.tensor(1.05), guard=guard, reduce_backend="torch")
    assert float(m["skipped"]) == 0.0  # the window never took the 50


def test_spike_median_and_finite_helpers_match_reference():
    rng = np.random.default_rng(0)
    for w in (1, 4, 7, 16):
        v = rng.standard_normal(w).astype(np.float32)
        assert float(optim.adamw._sorted_median(torch.from_numpy(v))) == \
            float(RO.adamw._sorted_median(jnp.asarray(v)))
    for x in (1.0, float("nan"), float("inf"), -float("inf")):
        assert bool(optim.adamw._finite_scalar(torch.tensor(x))) == \
            bool(RO.adamw._finite_scalar(jnp.float32(x)))


# ------------------------- the guarded train step ---------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["adamw", "fused-second-moment"])
def test_guarded_train_step_contracts_on_tiny_olmo(fused):
    """Tiny olmo on the CPU (kernel route, plain versions): a clean guarded
    step equals ``make_train_step``'s bitwise, with ``chaos_scale`` 1.0
    riding along; a NaN ``chaos_scale`` is counted by the census and
    skipped with the state bitwise unchanged."""
    cfg = get_arch("olmo-1b", tiny=True)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, fused_second_moment=fused)
    pa, sa, plain = train_cli.build(cfg, tcfg, "cpu")
    pb, sb, guarded = train_cli.build(cfg, tcfg, "cpu", guard=True)  # the same seeded init
    guard = optim.init_guard_state(4)
    data = SyntheticLM(cfg.vocab_size, 8, 2, seed=2)
    for _ in range(2):
        tokens = torch.from_numpy(data.next()["tokens"])
        pa, sa, ma = plain(pa, sa, {"tokens": tokens})
        pb, sb, guard, mb = guarded(pb, sb, guard, {"tokens": tokens,
                                                    "chaos_scale": torch.ones(1)})
        assert float(mb["skipped"]) == 0.0 and float(ma["loss"]) == float(mb["loss"])
        assert _same_bits(R.tree_leaves(pa), R.tree_leaves(pb))
        assert _same_bits(_state_leaves(sa), _state_leaves(sb))
    before_p = [t.detach().clone() for t in R.tree_leaves(pb)]
    before_s = [t.clone() for t in _state_leaves(sb)]
    tokens = torch.from_numpy(data.next()["tokens"])
    pb, sb, guard, mb = guarded(pb, sb, guard, {"tokens": tokens,
                                                "chaos_scale": torch.tensor([float("nan")])})
    n = sum(p.numel() for p in R.tree_leaves(pb))
    assert float(mb["skipped"]) == 1.0 and float(mb["nonfinite"]) == n
    assert _same_bits(R.tree_leaves(pb), before_p)
    assert _same_bits(_state_leaves(sb), before_s)
    assert int(guard.skipped) == 1


# ------------------------ ChaosMonkey and StepGuard -------------------------


def test_monkey_corrupt_fires_once_per_step():
    monkey = ChaosMonkey(nan_steps=(3,), inf_steps=(5,), leaf=1)
    g = {"a": torch.ones(2), "w": torch.ones(4)}
    out = monkey.corrupt(g, 3)
    assert torch.isnan(out["w"][0]) and torch.isfinite(out["w"][1:]).all()
    assert out["a"] is g["a"] and torch.isfinite(g["w"]).all()  # a copy is poisoned
    assert monkey.corrupt(g, 3) is g  # the replay of step 3 is clean
    assert int(torch.isinf(monkey.corrupt(g, 5)["w"]).sum()) == 1
    assert monkey.corrupt(g, 4) is g
    x = torch.ones(1)
    assert torch.isnan(ChaosMonkey(nan_steps=(1,)).corrupt(x, 1)).all()


def test_monkey_transient_and_preempt():
    guard = PreemptionGuard(install=False)
    monkey = ChaosMonkey(fail_steps=(2,), preempt_at=4)
    monkey.on_step(0, guard)
    with pytest.raises(TransientFault):
        monkey.on_step(2, guard)
    monkey.on_step(2, guard)  # fired already: the retry runs clean
    assert not guard.should_stop
    monkey.on_step(4, guard)
    assert guard.should_stop and monkey.calls == 4


def test_monkey_corrupt_shard_targets_one_host():
    x = torch.ones((8, 4))
    monkey = ChaosMonkey(nan_steps=(2,), host=5)
    flat = monkey.corrupt_shard(x, 2, shards=8).reshape(8, -1)
    assert torch.isnan(flat[5, 0]) and torch.isfinite(flat[5, 1:]).all()
    assert torch.isfinite(torch.cat([flat[:5], flat[6:]])).all()
    assert monkey.corrupt_shard(x, 2, shards=8) is x
    with pytest.raises(ValueError):
        ChaosMonkey(nan_steps=(1,)).corrupt_shard(torch.ones(7), 1, shards=2)


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_monkey_schedule_equals_reference(seed):
    kw = dict(n_steps=40, nan_rate=0.2, inf_rate=0.1, fail_rate=0.2, preempt_rate=0.1)
    a, b = ChaosMonkey.from_seed(seed, **kw, host=3), RefChaosMonkey.from_seed(seed, **kw)
    for name in ("nan_steps", "inf_steps", "fail_steps", "preempt_steps"):
        assert getattr(a, name) == getattr(b, name)
    assert a.host == 3 and 0 not in a.nan_steps | a.inf_steps | a.fail_steps


def test_stepguard_retry_backoff_schedule():
    sleeps = []
    sg = StepGuard(max_bad_steps=2, max_retries=4, backoff_s=0.1, backoff_cap_s=0.45,
                   sleep=sleeps.append)
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] <= 3:
            raise TransientFault("boom")
        return "ok"

    assert sg.retry(flaky) == "ok"
    assert attempts["n"] == 4 and sleeps == [0.1, 0.2, 0.4] and sg.transient_failures == 3


def test_stepguard_exhaustion_and_non_transient():
    sleeps = []
    sg = StepGuard(max_retries=2, backoff_s=0.01, sleep=sleeps.append)

    def always():
        raise TransientFault("down")

    with pytest.raises(TransientFault):
        sg.retry(always)
    assert len(sleeps) == 2

    def poisoned():
        raise ValueError("not transient")

    sleeps.clear()
    with pytest.raises(ValueError):
        sg.retry(poisoned)
    assert sleeps == []


def test_stepguard_consecutive_counting():
    sg = StepGuard(max_bad_steps=3)
    for skipped in (True, True, False, True, True):
        sg.record(skipped)
    assert not sg.should_rollback()
    sg.record(True)
    assert sg.should_rollback()
    sg.reset()
    assert not sg.should_rollback()
    with pytest.raises(ValueError):
        StepGuard(max_bad_steps=0)


# ------------------------------ TrainSupervisor ------------------------------


class _CountingData:
    """Batch i is the integer i, so the replay order is assertable."""

    def __init__(self):
        self.step = 0

    def next(self):
        b = {"x": self.step}
        self.step += 1
        return b

    def seek(self, step):
        self.step = int(step)

    def state(self):
        return {"step": self.step}


def _np_step_fn(monkey):
    def step_fn(state, batch):
        step = int(batch["x"])
        monkey.on_step(step)
        g = monkey.corrupt(torch.ones(3), step)
        if not torch.isfinite(g).all():
            return state, {"skipped": 1.0, "loss": 1.0}
        new = {"n": state["n"] + 1, "w": state["w"] + g.numpy()}
        return new, {"skipped": 0.0, "loss": 1.0}

    return step_fn


def _state0():
    return {"n": np.zeros((), np.int32), "w": np.zeros(3, np.float32)}


def test_supervisor_rollback_replays_from_recorded_data_step(tmp_path):
    monkey = ChaosMonkey(nan_steps=(3, 4, 5), fail_steps=(1,))
    sleeps = []
    sg = StepGuard(max_bad_steps=3, backoff_s=0.05, sleep=sleeps.append)
    sup = TrainSupervisor(_np_step_fn(monkey), CheckpointManager(tmp_path), _CountingData(),
                          ckpt_every=2, step_guard=sg)
    state, step, status = sup.run(_state0(), 8)
    assert status == "done" and step == 8
    assert sg.rollbacks == 1 and sg.transient_failures == 1 and sleeps == [0.05]
    assert int(state["n"]) == 8  # no batch lost, none applied twice
    np.testing.assert_allclose(state["w"], 8.0)


def test_supervisor_anchor_checkpoint_enables_early_rollback(tmp_path):
    monkey = ChaosMonkey(nan_steps=(0, 1))
    sg = StepGuard(max_bad_steps=2, sleep=lambda s: None)
    sup = TrainSupervisor(_np_step_fn(monkey), CheckpointManager(tmp_path), _CountingData(),
                          ckpt_every=100, step_guard=sg)
    state, step, status = sup.run(_state0(), 4)
    assert status == "done" and step == 4 and sg.rollbacks == 1
    assert int(state["n"]) == 4


def test_supervisor_never_commits_mid_skip_streak(tmp_path):
    monkey = ChaosMonkey(nan_steps=(3, 4))
    sg = StepGuard(max_bad_steps=5, sleep=lambda s: None)
    ckpt = CheckpointManager(tmp_path)
    sup = TrainSupervisor(_np_step_fn(monkey), ckpt, _CountingData(), ckpt_every=4,
                          step_guard=sg)
    state, _, status = sup.run(_state0(), 6)
    assert status == "done" and ckpt.latest() == 0  # step 4 was a skip: no commit
    assert int(state["n"]) == 4


def test_rollback_without_checkpoint_raises(tmp_path):
    sup = TrainSupervisor(lambda s, b: (s, {}), CheckpointManager(tmp_path), _CountingData())
    with pytest.raises(RuntimeError):
        sup._rollback({"w": np.zeros(2, np.float32)})


def test_resume_waits_for_inflight_save(tmp_path):
    """``resume`` drains the writer before it scans: a save whose flush has
    not landed is found, not skipped."""
    inner = CheckpointManager(tmp_path)
    release = threading.Event()

    class Delayed:
        def __init__(self):
            self.t = None

        def save(self, step, tree, extra=None):
            def run():
                release.wait()
                inner.save(step, tree, extra=extra, blocking=True)
            self.t = threading.Thread(target=run, daemon=True)
            self.t.start()

        def wait(self):
            release.set()
            if self.t is not None:
                self.t.join()
            inner.wait()

        def __getattr__(self, name):
            return getattr(inner, name)

    ckpt = Delayed()
    ckpt.save(7, {"w": np.full(2, 7.0, np.float32)}, extra={"data_step": 7})
    assert ckpt.latest() is None
    data = SyntheticLM(100, 8, 2, seed=0)
    got, start = TrainSupervisor(lambda s, b: (s, {}), ckpt, data).resume(
        {"w": np.zeros(2, np.float32)})
    assert start == 7 and float(got["w"][0]) == 7.0 and data.state()["step"] == 7


def test_supervisor_preempts_and_resumes(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    guard = PreemptionGuard(install=False)
    monkey = ChaosMonkey(preempt_at=3)

    def step_fn(state, batch):
        monkey.on_step(int(batch["x"]) + 1, guard)
        return {"n": state["n"] + 1, "w": state["w"]}, {}

    data = _CountingData()
    sup = TrainSupervisor(step_fn, ckpt, data, ckpt_every=100, guard=guard)
    state, step, status = sup.run(_state0(), 10)
    assert status == "preempted" and step == 3 and ckpt.latest() == 3
    data2 = _CountingData()
    state2, start = TrainSupervisor(step_fn, ckpt, data2).resume(_state0())
    assert start == 3 and int(state2["n"]) == 3 and data2.step == 3


def test_heartbeat_elastic_and_preemption_guard():
    hb = HeartbeatTracker(4, timeout_s=10.0)
    for h in range(4):
        hb.beat(h, 1.0 if h != 2 else 5.0, now=0.0)
    hb.beat(0, 1.0, now=15.0)
    assert hb.dead_hosts(now=15.0) == [1, 2, 3] and hb.healthy(now=15.0) == [0]
    assert hb.stragglers() == [2]
    for n in (8, 7, 5):
        kw = dict(n_hosts=8, devices_per_host=4, model_degree=8, global_batch=64)
        assert ElasticPlan(**kw).plan(list(range(n))) == RefElasticPlan(**kw).plan(
            list(range(n)))
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    assert signal.getsignal(signal.SIGTERM) != before
    guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


# ------------------------- the CLI's guarded loop -----------------------------

ARGS = ["--arch", "olmo-1b", "--tiny", "--batch", "2", "--seq", "16", "--device", "cpu",
        "--guard", "--log-every", "1"]


def test_cli_guard_rollback_replays_losses(tmp_path, capsys):
    """NaN on steps 2, 3, 4 and a transient fault on step 1: the run
    retries step 1, skips three steps, rolls back to the step-0 anchor
    and replays. The replayed steps 1 and 2 give the first run's losses
    bitwise (step 2's poisoned attempt computed its loss before the skip,
    from the same state); every loss is finite; the run ends at step 6
    with a commit at step 5."""
    losses = train_cli.main(ARGS + ["--steps", "6", "--ckpt-every", "5",
                                    "--ckpt-dir", str(tmp_path)],
                            chaos=ChaosMonkey(nan_steps=(2, 3, 4), fail_steps=(1,)))
    out = capsys.readouterr().out
    assert "guard: step 1 retried after 1 transient fault(s)" in out
    for s in (2, 3, 4):
        assert f"guard: step {s} skipped" in out
    assert "guard: rolled back to step 0 (data step 0)" in out
    assert "commit step 5: skipped 3/9 retries 1 rollbacks 1" in out
    assert "checkpoint restore step 0:" in out and "CRC verified" in out
    assert len(losses) == 4 + 6 and all(np.isfinite(losses))
    assert losses[4] == losses[0] and losses[5] == losses[1]
    clean = train_cli.main(ARGS + ["--steps", "6"])
    assert losses[4:] == clean  # the recovered run is the clean run, bitwise


def test_cli_chaos_seed_schedule(tmp_path, capsys):
    """``--chaos 0.5 --chaos-seed 99 --steps 12``: the reference's schedule
    for that seed (NaN on steps 2, 3, 4; transient faults on 1, 6, 7, 11)."""
    losses = train_cli.main(ARGS + ["--steps", "12", "--chaos", "0.5", "--chaos-seed", "99",
                                    "--ckpt-dir", str(tmp_path), "--log-every", "12"])
    out = capsys.readouterr().out
    assert "nan_steps=[2, 3, 4] fail_steps=[1, 6, 7, 11]" in out
    assert "guard: rolled back to step 0 (data step 0)" in out
    assert out.count("retried after") == 4 and all(np.isfinite(losses))
    assert (tmp_path / "guard_status.json").exists()


def test_cli_resumes_from_a_commit(tmp_path, capsys):
    """A run cut at step 3 (preempted) resumes from its commit and ends
    where a straight run ends, bitwise."""
    args = ["--arch", "olmo-1b", "--tiny", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--steps", "5", "--ckpt-dir", str(tmp_path)]
    first = train_cli.main(args + ["--guard"], chaos=ChaosMonkey(preempt_at=3))
    assert "preempted" in capsys.readouterr().out and len(first) == 3
    rest = train_cli.main(args)
    assert "resumed from step 3" in capsys.readouterr().out
    assert first + rest == train_cli.main(["--arch", "olmo-1b", "--tiny", "--batch", "2",
                                           "--seq", "16", "--device", "cpu", "--steps", "5"])

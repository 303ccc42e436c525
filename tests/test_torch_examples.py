"""The reference's examples as the port's entry points
(``repro_torch.examples``), on the CPU at their small sizes.

  * ``train_100m``'s ``CFG_100M`` and its ``--smoke`` sibling equal the
    reference's field by field (``examples/train_100m.py``, loaded by path;
    its sibling is built inside its ``main``, so it is caught at the
    ``init_params`` call).
  * Six ``--smoke`` steps from the reference's ``init_params(PRNGKey(0))``
    weights, carried across by ``params_from_jax`` and fed the same
    ``SyntheticLM`` batches, give the reference's losses step by step
    within one bf16 ulp (2^-7 relative). Both packages report the loss
    through the config flags' MMA mean, whose group sums re-enter at bf16
    (the losses are bf16 values), so a per-token loss a few f32 ulps apart
    can move the reported loss by one bf16 ulp (observed: 0). A planted
    fault -- the training CLI's lr of 3e-4 for the example's 6e-4 -- moves
    the losses by 5-11% from step 2 on, and must fail that limit.
  * The CLI's ``--smoke`` (the cuda_fused reduce backend, the plain
    versions on the CPU) trains with a falling loss and puts the process
    default back.
  * ``serve_batched`` gives 6 and 4 outputs of 8 tokens, the same on a
    rerun (``tests/test_system.py`` holds the reference to the same).
  * ``quickstart``'s sums agree and its loss falls.
  * Each example raises with no GPU and no ``--device``.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import reduce as R
from repro_torch.examples import quickstart, serve_batched, train_100m
from repro_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
FRAMEWORK = {"use_pallas", "use_kernels"}
LOSS_REL = 2.0**-7  # one bf16 ulp of the reported loss


class _Caught(Exception):
    pass


@pytest.fixture(scope="module")
def ref_example():
    spec = importlib.util.spec_from_file_location("ref_train_100m",
                                                  ROOT / "examples" / "train_100m.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ref_smoke_cfg(ref_example):
    """The config the reference's ``main(["--smoke"])`` builds."""
    seen = []

    def catch(key, cfg):
        seen.append(cfg)
        raise _Caught

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_example, "init_params", catch)
        with pytest.raises(_Caught):
            ref_example.main(["--smoke"])
    return seen[0]


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_configs_are_the_reference(ref_example, which):
    if which == "full":
        port, ref = train_100m.CFG_100M, ref_example.CFG_100M
    else:
        port, ref = train_100m.SMOKE_CFG, _ref_smoke_cfg(ref_example)
    pf, rf = _fields(port), _fields(ref)
    for name, value in rf.items():
        if name in FRAMEWORK:
            continue
        if name in pf:
            assert pf[name] == value, name
        else:
            assert not value, f"{name} is set in the reference but not ported"
    assert port.param_count() == ref.param_count()
    assert port.pattern_layers == ref.pattern_layers


@pytest.fixture(scope="module")
def smoke_runs(ref_example):
    """The reference's ``main(["--smoke"])`` losses, and the port's ``run``
    from the same weights, clean and with the planted fault."""
    ref_losses = ref_example.main(["--smoke"])
    rcfg = _ref_smoke_cfg(ref_example)
    rparams, _ = ref_example.init_params(jax.random.PRNGKey(0), rcfg)
    steps, batch, seq = train_100m.SMOKE_STEPS, train_100m.SMOKE_BATCH, train_100m.SMOKE_SEQ

    def port(lr=None):
        params = params_from_jax(jax.tree.map(np.asarray, rparams), train_100m.SMOKE_CFG)
        if lr is None:
            return train_100m.run(train_100m.SMOKE_CFG, params, steps, batch, seq, "cpu")
        with pytest.MonkeyPatch.context() as mp:
            base = train_100m.train_config
            mp.setattr(train_100m, "train_config",
                       lambda n: dataclasses.replace(base(n), learning_rate=lr))
            return train_100m.run(train_100m.SMOKE_CFG, params, steps, batch, seq, "cpu")

    return ref_losses, port(), port(lr=3e-4)


def _gaps(got, want) -> list:
    return [abs(g - w) / abs(w) for g, w in zip(got, want)]


def test_smoke_losses_match_the_reference_step_by_step(smoke_runs):
    ref_losses, port_losses, _ = smoke_runs
    assert len(port_losses) == len(ref_losses) == train_100m.SMOKE_STEPS
    assert max(_gaps(port_losses, ref_losses)) <= LOSS_REL
    assert port_losses[-1] < port_losses[0]


def test_planted_fault_fails_the_loss_limit(smoke_runs):
    ref_losses, _, faulty = smoke_runs
    assert max(_gaps(faulty, ref_losses)) > 10 * LOSS_REL


def test_smoke_cli_trains_and_restores_the_default_backend(capsys):
    before = R.set_default_backend("torch")
    try:
        losses = train_100m.main(["--smoke", "--device", "cpu"])
        assert R.set_default_backend(None) == "torch"
    finally:
        R.set_default_backend(before)
    out = capsys.readouterr().out
    assert len(losses) == train_100m.SMOKE_STEPS and losses[-1] < losses[0]
    assert "llama-110m-smoke" in out and "step wall p50" in out


def test_serve_batched_outputs_and_rerun():
    outs = serve_batched.main(["--device", "cpu"])
    assert [[len(o) for o in run] for run in outs] == [[8] * 6, [8] * 4]
    assert outs == serve_batched.main(["--device", "cpu"])  # greedy decode is deterministic


def test_quickstart_sums_agree_and_loss_falls(capsys):
    out = quickstart.main(["--device", "cpu"])
    x = torch.from_numpy(np.random.RandomState(0).randn(quickstart.N).astype(np.float32))
    want = float(x.to(torch.bfloat16).double().sum())  # the bf16 multipliers' exact sum
    mass = float(x.abs().sum())
    assert abs(out["reduce"] - want) <= 1e-6 * mass
    # mma_sum's group sums re-enter its second product at bf16
    assert abs(out["mma_sum"] - want) <= 1e-6 * mass + 2.0**-8 * abs(want)
    assert out["levels"] == 2 and out["speedup"] == pytest.approx(11.2)
    losses = out["losses"]
    assert len(losses) == quickstart.STEPS and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "quickstart OK" in capsys.readouterr().out


@pytest.mark.parametrize("module,argv", [(quickstart, []), (serve_batched, []),
                                         (train_100m, ["--smoke"])],
                         ids=["quickstart", "serve_batched", "train_100m"])
def test_needs_a_device_or_a_gpu(monkeypatch, module, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)

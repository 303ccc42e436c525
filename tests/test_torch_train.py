"""Port parity of the training path on tiny olmo-1b, and its pieces.

  * ``repro_torch.data.SyntheticLM`` gives the reference's tokens, bit for
    bit (same ``SeedSequence([seed, step, shard])`` stream).
  * The backward passes of K5 (layernorm_np / rmsnorm: host math) and K6
    (flash attention: dense recompute) against ``jax.grad`` of the
    reference's custom VJPs.
  * Two train steps of tiny olmo from the reference's own ``init_params``
    (carried over by ``params_from_jax``): the port with its kernels
    (plain versions on the CPU) and ``reduce_backend`` cuda_fused against
    the reference with ``use_pallas=True`` and pallas_fused (interpret
    mode); plain AdamW, the fused second moment, and 2 microbatches. Per
    step: loss, grad norm, clip coefficient and every parameter.
  * The CLI on the CPU, and its refusal without a GPU or ``--device``, of
    ``--mesh`` without ``--guard`` or with a batch that does not divide by
    the world, and of ``--chaos`` without ``--guard``.

Tolerances (tiny olmo is f32):
  * loss 1e-3: the token sum (K1) rounds each per-token loss to bf16, as
    the reference does; a per-token loss a few f32 ulps apart can round
    the other way, moving the mean by 2^-8 x ~6.5 / 32 tokens = 8e-4
    (observed 0).
  * grad norm and clip 1e-4 relative: the same f32 math summed in other
    orders, after forwards that round the same intermediates to bf16
    (observed 2e-5).
  * parameters: with the fused second moment the update is a smooth
    function of the gradients: 1e-5 (observed 6e-7). Plain AdamW's first
    steps move each weight by about lr x sign(g), so a gradient component
    near 0 whose sign differs between the packages moves by up to 2 lr per
    step: every weight within 2 lr x steps, and all but 0.1% within 1e-5
    (observed 25 of 139264).
  * K5/K6 gradients 1e-5: the same f32 closed forms (K5) and the same
    dense f32 recompute (K6), in other summation orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro import reduce as RR
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_arch as ref_arch
from repro.data import ShardInfo as RefShardInfo
from repro.data import SyntheticLM as RefSyntheticLM
from repro.kernels import flash_attention_diff as ref_flash_attention_diff
from repro.kernels import layernorm_np as ref_layernorm_np
from repro.kernels import rmsnorm as ref_rmsnorm
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import init_params as ref_init_params
from repro_torch import kernels as K
from repro_torch import reduce as R
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data import ShardInfo, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_jax, reference_leaf_groups

BATCH, SEQ, STEPS = 2, 16, 2


@pytest.mark.parametrize("shard,codebooks", [(0, 0), (1, 0), (0, 2)])
def test_synthetic_tokens_identical(shard, codebooks):
    ref = RefSyntheticLM(256, 24, 3, RefShardInfo(shard, 2), seed=7, n_codebooks=codebooks)
    port = SyntheticLM(256, 24, 3, ShardInfo(shard, 2), seed=7, n_codebooks=codebooks)
    for _ in range(3):
        np.testing.assert_array_equal(port.next()["tokens"], ref.next()["tokens"])
    ref.seek(10)
    port.seek(10)
    assert port.state() == ref.state()
    np.testing.assert_array_equal(port.next()["tokens"], ref.next()["tokens"])


def _grads_of(fn_ref, fn_port, arrays, g):
    want = jax.grad(lambda *a: jnp.sum(fn_ref(*a) * jnp.asarray(g)),
                    argnums=tuple(range(len(arrays))))(*[jnp.asarray(a) for a in arrays])
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = torch.autograd.grad(fn_port(*leaves), leaves, torch.from_numpy(g))
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_norm_backward_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((37, 64)) * 3 + 1).astype(np.float32)
    gam = (rng.random(64) + 0.5).astype(np.float32)
    g = rng.standard_normal((37, 64)).astype(np.float32)
    _grads_of(lambda a: ref_layernorm_np(a, 1e-5), lambda a: K.layernorm_np(a, 1e-5), [x], g)
    _grads_of(lambda a, b: ref_rmsnorm(a, b, 1e-6), lambda a, b: K.rmsnorm(a, b, 1e-6),
              [x, gam], g)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 24)])
def test_attention_backward_matches_reference(causal, window):
    rng = np.random.default_rng(1)
    q = (rng.standard_normal((1, 4, 40, 32)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((1, 2, 40, 32)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((1, 2, 40, 32)) * 0.5).astype(np.float32)
    g = rng.standard_normal(q.shape).astype(np.float32)
    _grads_of(lambda a, b, c: ref_flash_attention_diff(a, b, c, causal, window, 0, None),
              lambda a, b, c: K.flash_attention_diff(a, b, c, causal, window, 0, None),
              [q, k, v], g)


@pytest.fixture
def kernel_backends():
    RR.set_default_backend("pallas_fused")
    R.set_default_backend("cuda_fused")
    yield
    RR.set_default_backend(None)
    R.set_default_backend(None)


@pytest.mark.parametrize("fused,micro", [(False, 1), (True, 1), (False, 2)],
                         ids=["adamw", "fused-second-moment", "microbatches-2"])
def test_tiny_olmo_steps_match_reference(kernel_backends, fused, micro):
    rcfg = dataclasses.replace(ref_arch("olmo-1b", tiny=True), use_pallas=True)
    pcfg = get_arch("olmo-1b", tiny=True)
    kw = dict(total_steps=STEPS, warmup_steps=1, microbatches=micro, fused_second_moment=fused)
    rparams, _ = ref_init_params(jax.random.PRNGKey(0), rcfg)
    ropt = RO.init_state(rparams, fused_second_moment=fused)
    rstep = jax.jit(ref_make_train_step(rcfg, RefTrainConfig(**kw)))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), pcfg)
    pparams, popt, pstep = train_cli.build(pcfg, TrainConfig(**kw), "cpu", params=pparams)
    if fused:  # one scalar v per REFERENCE leaf
        assert len(popt.v) == len(jax.tree.leaves(rparams)) == 8
        assert len(set(reference_leaf_groups(pparams, pcfg))) == 8
    data = RefSyntheticLM(pcfg.vocab_size, SEQ, BATCH, seed=0)
    lr = TrainConfig().learning_rate
    for step in range(1, STEPS + 1):
        tokens = data.next()["tokens"]
        rparams, ropt, rm = rstep(rparams, ropt, {"tokens": jnp.asarray(tokens)})
        pparams, popt, pm = pstep(pparams, popt, {"tokens": torch.from_numpy(tokens)})
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= 1e-3
        for key in ("grad_norm", "clip", "lr"):
            assert float(pm[key]) == pytest.approx(float(rm[key]), rel=1e-4), key
        want = R.tree_leaves(params_from_jax(jax.tree.map(np.asarray, rparams), pcfg))
        got = [p.detach() for p in R.tree_leaves(pparams)]
        diffs = torch.cat([(w - g).abs().reshape(-1) for w, g in zip(want, got)])
        if fused:
            assert float(diffs.max()) <= 1e-5
        else:
            assert float(diffs.max()) <= 2 * lr * step
            assert int((diffs > 1e-5).sum()) <= 1e-3 * diffs.numel()


def test_cli_tiny_on_cpu(capsys):
    losses = train_cli.main(["--arch", "olmo-1b", "--tiny", "--steps", "2", "--batch", "2",
                             "--seq", "16", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert out.count("ms/step") == 2 and "step     2 loss" in out


def test_cli_needs_a_device_or_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "olmo-1b", "--tiny", "--steps", "1"])
    # refused, as the reference refuses them: the mesh without the guard,
    # a global batch that does not divide by the mesh's ranks (3 here, read
    # from the launcher's environment before any process group forms), and
    # the chaos drill without the guard
    monkeypatch.setenv("WORLD_SIZE", "3")
    for flag in (["--mesh"], ["--guard", "--mesh", "--batch", "4"], ["--chaos", "0.1"]):
        with pytest.raises(SystemExit):
            train_cli.main(["--arch", "olmo-1b", "--tiny", "--device", "cpu"] + flag)
    assert not torch.distributed.is_initialized()

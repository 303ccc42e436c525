"""The training CLI's fit check (``launch.train.train_step_peak_bytes``,
``check_fits_card``) and the leaner training step it charges.

  * ``param_shapes`` (the meta device) against the tensors ``init_params``
    allocates for every tiny arch: the same numels and element sizes.
  * The guarded model at or above the unguarded one, for every arch.
  * On a mocked 80 GB card: recurrentgemma-9b refused at 9 layers and
    accepted at 6 (guarded: refused at 6, accepted at 3); every depth and
    arch that ``chip_smoke.py`` trains accepted, plain and guarded.
  * The step: gradients accumulated into f32 without a cast's copy and
    averaged in place, AdamW's temporaries scoped to their leaf, held
    BITWISE to the earlier arithmetic (a cast, a fresh averaged copy, one
    loop over the leaves) on a tiny arch in bf16 with two microbatches.
"""

import dataclasses

import pytest
import torch

from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.configs import TINY_ARCHS, TrainConfig, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import _split_batch
from repro_torch.models import init_params
from repro_torch.models.convert import reference_leaf_groups
from repro_torch.models.losses import lm_loss_chunked
from repro_torch.models.model import forward_hidden

H100_BYTES = 85_045_395_456  # an H100 80GB HBM3's total_memory


@pytest.fixture
def card(monkeypatch):
    """A mocked 80 GB card: ``check_fits_card`` reads its memory; nothing
    may allocate parameters on the way."""

    class Props:
        total_memory = H100_BYTES

    def no_alloc(*args, **kwargs):
        raise AssertionError("the CLI allocated parameters before its size check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
    monkeypatch.setattr(train_cli, "init_params", no_alloc)
    return torch.device("cuda")


@pytest.mark.parametrize("arch", sorted(TINY_ARCHS))
def test_param_shapes_equal_the_allocated_tensors(arch):
    cfg = get_arch(arch, tiny=True)
    leaves = R.tree_leaves(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert train_cli.param_shapes(cfg) == [(t.numel(), t.element_size()) for t in leaves]
    assert len(leaves) == train_cli.param_leaves(cfg)


@pytest.mark.parametrize("arch", sorted(TINY_ARCHS))
@pytest.mark.parametrize("fused", [False, True])
def test_guarded_model_at_least_unguarded(arch, fused):
    cfg = get_arch(arch)
    tcfg = TrainConfig(fused_second_moment=fused)
    plain = train_cli.train_step_peak_bytes(cfg, tcfg)
    guarded = train_cli.train_step_peak_bytes(cfg, tcfg, guard=True)
    assert guarded >= plain > 0


def test_recurrentgemma_peak_model_matches_the_measured_peaks():
    # an H100 80GB measured 67.10 GB (plain) and 75.49 GB (guarded) at 3
    # layers (PERF.md section 5): the step's own bytes, within 0.1 GB
    cut = dataclasses.replace(get_arch("recurrentgemma-9b"), n_layers=3)
    tcfg = TrainConfig()
    assert 67.0e9 < train_cli.train_step_peak_bytes(cut, tcfg) < 67.1e9
    assert 75.4e9 < train_cli.train_step_peak_bytes(cut, tcfg, guard=True) < 75.5e9


@pytest.mark.parametrize("arch,layers,guard", [
    ("olmo-1b", None, False), ("olmo-1b", None, True), ("olmo-1b", 2, True),
    ("internlm2-1.8b", None, False), ("internlm2-1.8b", None, True),
    ("granite-moe-1b-a400m", None, False), ("granite-moe-1b-a400m", None, True),
    ("mamba2-780m", None, False), ("mamba2-780m", None, True),
    ("minicpm3-4b", 16, False), ("minicpm3-4b", 16, True),
    ("llama-3.2-vision-11b", 10, False), ("llama-3.2-vision-11b", 10, True),
    ("recurrentgemma-9b", 6, False), ("recurrentgemma-9b", 3, False),
    ("recurrentgemma-9b", 3, True),
])
def test_chip_smoke_training_depths_accepted(card, arch, layers, guard):
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    train_cli.check_fits_card(cfg, TrainConfig(), card, guard=guard)


@pytest.mark.parametrize("arch,layers,guard", [
    ("recurrentgemma-9b", 9, False), ("recurrentgemma-9b", 6, True),
    ("recurrentgemma-9b", None, False), ("minicpm3-4b", None, False),
    ("deepseek-7b", None, False), ("llama-3.2-vision-11b", None, True),
])
def test_steps_past_the_card_refused(card, arch, layers, guard):
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    with pytest.raises(ValueError, match="sharded over more cards"):
        train_cli.check_fits_card(cfg, TrainConfig(), card, guard=guard)


@pytest.mark.parametrize("arch,ranks_on_card,world,fits", [
    ("olmo-1b", 2, 2, True),           # chip_smoke.py's data mesh: two replicas on one card
    ("olmo-1b", 1, 4, True),           # four ranks, each on a card of its own
    ("olmo-1b", 3, 3, False),          # three replicas and their reserves pass 80 GB
    ("internlm2-1.8b", 2, 2, False),   # one guarded replica alone takes 41 GB
    ("internlm2-1.8b", 1, 2, True),
])
def test_data_mesh_charges_every_rank_on_the_card(card, arch, ranks_on_card, world, fits):
    cfg, tcfg = get_arch(arch), TrainConfig()
    per_rank = (train_cli.train_step_peak_bytes(cfg, tcfg, guard=True)
                + train_cli.ACTIVATION_RESERVE_BYTES + train_cli.combine_peak_bytes(cfg, world))
    largest = max(k for k, _ in train_cli.param_shapes(cfg))
    assert train_cli.combine_peak_bytes(cfg, world) == 4 * largest * (world + 1)
    assert (per_rank * ranks_on_card <= H100_BYTES) == fits
    if fits:
        train_cli.check_fits_card(cfg, tcfg, card, guard=True, ranks_on_card=ranks_on_card,
                                  world=world)
    else:
        with pytest.raises(ValueError, match="sharded over more cards"):
            train_cli.check_fits_card(cfg, tcfg, card, guard=True,
                                      ranks_on_card=ranks_on_card, world=world)


def test_train_cli_refuses_guarded_depth_before_allocating(card):
    # the plain step at 6 layers fits, the guarded one does not: main passes
    # --guard to the check
    six = dataclasses.replace(get_arch("recurrentgemma-9b"), n_layers=6)
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "recurrentgemma-9b", "--steps", "1", "--guard"], cfg=six)


def _earlier_step(params, opt_state, batch, cfg, tcfg):
    """The step's earlier arithmetic: each gradient cast to f32 before its
    add, the average a fresh copy, AdamW in one loop over the leaves."""
    leaves = R.tree_leaves(params)
    n_micro = tcfg.microbatches
    gacc = [torch.zeros(p.shape, dtype=torch.float32) for p in leaves]
    for mb in _split_batch(batch["tokens"], n_micro):
        h, aux = forward_hidden(params, cfg, mb[:, :-1].to(torch.int64), None)
        loss, _ = lm_loss_chunked(params, cfg, h, mb[:, 1:].to(torch.int64), aux)
        grads = torch.autograd.grad(loss, leaves)
        for a, g in zip(gacc, grads):
            a.add_(g.to(torch.float32))
    grads = [a / n_micro for a in gacc]
    backend = R.backend_for_flags(cfg.mma_reductions, cfg.use_kernels)
    _, clip = optim.global_norm_and_clip(grads, tcfg.grad_clip, backend=backend)
    state = opt_state
    step = state.step + 1
    lr = optim.cosine_lr(tcfg, step)
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - tcfg.b1**stepf, 1 - tcfg.b2**stepf
    with torch.no_grad():
        for p, g, m, v in zip(leaves, grads, state.m, state.v):
            gf = g.to(torch.float32) * clip
            m_new = m.mul_(tcfg.b1).add_((1 - tcfg.b1) * gf)
            v_new = v.mul_(tcfg.b2).add_((1 - tcfg.b2) * gf * gf)
            mhat = m_new / bc1
            vhat = v_new / bc2
            pf = p.to(torch.float32)
            delta = mhat / (torch.sqrt(vhat) + optim.adamw.ADAM_EPS) + tcfg.weight_decay * pf
            p.copy_(pf - lr * delta)
    state.step = step


@pytest.mark.parametrize("arch", ["olmo-1b", "recurrentgemma-9b"])
def test_step_bitwise_the_earlier_arithmetic(arch):
    cfg = dataclasses.replace(get_arch(arch, tiny=True), dtype="bfloat16")
    tcfg = TrainConfig(microbatches=2, total_steps=4, warmup_steps=1)
    init = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    pa, oa, step_fn = train_cli.build(cfg, tcfg, "cpu", params=init)
    pb = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for p in R.tree_leaves(pb):
        p.requires_grad_(True)
    ob = optim.init_state(pb, leaf_groups=reference_leaf_groups(pb, cfg))
    data = SyntheticLM(cfg.vocab_size, 16, 4, seed=5)
    for _ in range(2):
        batch = {"tokens": torch.from_numpy(data.next()["tokens"])}
        pa, oa, _ = step_fn(pa, oa, batch)
        _earlier_step(pb, ob, batch, cfg, tcfg)
    bits = {2: torch.int16, 4: torch.int32}
    for a, b in zip(R.tree_leaves(pa) + oa.m + oa.v, R.tree_leaves(pb) + ob.m + ob.v):
        assert a.dtype == b.dtype
        assert torch.equal(a.detach().reshape(-1).view(bits[a.element_size()]),
                           b.detach().reshape(-1).view(bits[b.element_size()]))
    assert int(oa.step) == int(ob.step) == 2


def _sharded_fit(card, arch, layers, shape, rules="DEFAULT_RULES"):
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.model import param_axes

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    mesh = abstract_mesh(shape, ("data", "model"))
    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    specs = SH.param_shardings(param_axes(cfg), mesh, getattr(SH, rules), meta)
    train_cli.check_fits_card(cfg, TrainConfig(), card, ranks_on_card=4, world=4,
                              shard=(mesh, specs))


@pytest.mark.parametrize("arch,layers,shape,rules", [
    ("deepseek-7b", 3, (2, 2), "DEFAULT_RULES"),
    ("granite-moe-1b-a400m", 6, (2, 2), "SMALL_MODEL_RULES"),
    ("minicpm3-4b", 2, (2, 2), "DEFAULT_RULES"),
    ("llama-3.2-vision-11b", 5, (2, 2), "DEFAULT_RULES"),
    ("recurrentgemma-9b", 3, (1, 4), "DEFAULT_RULES"),
])
def test_chip_smoke_sharded_runs_fit_four_ranks_on_a_card(card, arch, layers, shape, rules):
    """The sharded phase's archs, depths and meshes: four ranks sharing one
    card, each charged its blocks' peak with AdamW's temporaries of one
    piece, the reserve over its batch ranks and its CUDA context."""
    _sharded_fit(card, arch, layers, shape, rules)


def test_recurrentgemma_on_2x2_does_not_fit_four_ranks_on_a_card(card):
    """On (data 2, model 2) a rank holds half of the 256 000-row embedding
    and head, with their moments, accumulators and gradients: 16.8 GB,
    past a quarter of the card with the reserve at any depth."""
    with pytest.raises(ValueError, match="sharded over more cards"):
        _sharded_fit(card, "recurrentgemma-9b", 1, (2, 2))

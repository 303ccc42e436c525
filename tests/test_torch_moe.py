"""Port parity of the MoE FFN: ``repro_torch.models.moe`` against
``repro.models.moe`` from the same weights, carried across.

  * ``moe_apply``'s output and its three metrics at f32 (1e-5 relative),
    with capacity drops (cf = 0.5) and without (cf = 4.0), SwiGLU and GELU
    experts;
  * the routing itself exactly: the top-k expert ids, the slot tables'
    tokens and the keep mask bitwise, the slot gates within 1e-6 relative
    (the router product and the softmax are f32 sums in other orders on
    the two sides); ``_dispatch_row`` on the same routed pairs bitwise,
    gates included;
  * the gradients of the output and the aux terms to the input, the router
    and the experts against ``jax.grad`` (1e-4 relative: f32 products of
    other orders, through the softmax and the gate renormalization);
  * the reference's routing properties (``tests/test_moe.py``): the dense
    oracle without drops, bounded drops, the aux lower bound under uniform
    routing, gate-weighted conservation, the dispatch offsets against the
    searchsorted oracle, and the output bitwise invariant to the backend
    of the slot-base scan;
  * ``layers.softmax_mma`` with the paper's technique on and off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _optional_hypothesis import hypothesis, st
from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.convert import tensor_from_numpy

RTOL = 1e-5


def _cfgs(E, k, cf, kind="swiglu", d=32, ff=16):
    kw = dict(name="t", family="moe", n_layers=1, d_model=d, n_heads=2, n_kv_heads=2,
              d_head=16, d_ff=0, vocab_size=64, dtype="float32", ffn_kind=kind)
    return (RefModelConfig(moe=RefMoEConfig(E, k, ff, capacity_factor=cf), **kw),
            ModelConfig(moe=MoEConfig(E, k, ff, capacity_factor=cf), **kw))


def _weights(rcfg, seed=0):
    rp, _ = RMOE.moe_init(jax.random.PRNGKey(seed), rcfg)
    return rp, {k: tensor_from_numpy(np.asarray(v)) for k, v in rp.items()}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ref_tables(rp, x, rcfg):
    """The reference's routing of x, step by step as its moe_apply runs it."""
    e = rcfg.moe
    logits = jnp.asarray(x) @ rp["router"]
    probs = RL.softmax_mma(logits, mma=rcfg.mma_reductions)
    gv, ei = jax.lax.top_k(probs, e.top_k)
    gv = gv / jnp.maximum(jnp.sum(gv, -1, keepdims=True), 1e-9)
    cap = int(max(1, round(x.shape[1] * e.top_k / e.n_experts * e.capacity_factor)))
    tok, gate, keep = jax.vmap(
        lambda a, b: RMOE._dispatch_row(a, b, e.n_experts, cap, backend="mma_jnp"))(ei, gv)
    return np.asarray(ei), np.asarray(tok), np.asarray(gate), np.asarray(keep)


@pytest.mark.parametrize("cf", [0.5, 4.0], ids=["drops", "no-drops"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_moe_apply_matches_reference(kind, cf):
    rcfg, pcfg = _cfgs(8, 2, cf, kind)
    rp, pp = _weights(rcfg)
    assert ("gate" in pp) == (kind == "swiglu")
    x = _x((3, 16, 32))
    want, wm = RMOE.moe_apply(rp, jnp.asarray(x), rcfg)
    got, gm = M.moe_apply(pp, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    for key in ("moe_aux", "moe_z", "moe_drop_frac"):
        assert float(gm[key]) == pytest.approx(float(wm[key]), rel=RTOL, abs=1e-9), key
    assert (float(gm["moe_drop_frac"]) > 0.0) == (cf < 1.0)
    # the routing tables: discrete decisions compared exactly
    ei, tok, gate, keep = _ref_tables(rp, x, rcfg)
    r = M.route(pp, torch.from_numpy(x), pcfg)
    np.testing.assert_array_equal(r.expert_ix.numpy(), ei)
    np.testing.assert_array_equal(r.slot_token.numpy(), tok)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(r.slot_gate.numpy(), gate, rtol=1e-6, atol=0)


@pytest.mark.parametrize("cap", [3, 40], ids=["drops", "no-drops"])
def test_dispatch_row_matches_reference_bitwise(cap):
    E, k, s, b = 8, 2, 33, 3
    rng = np.random.default_rng(cap)
    ei = rng.integers(0, E, size=(b, s, k))
    gv = rng.random((b, s, k)).astype(np.float32)
    tok, gate, keep, token_slots = M._dispatch_row(torch.from_numpy(ei), torch.from_numpy(gv),
                                                   E, cap, backend="mma_torch")
    for row in range(b):
        wtok, wgate, wkeep = RMOE._dispatch_row(jnp.asarray(ei[row]), jnp.asarray(gv[row]), E,
                                                cap, backend="mma_jnp")
        np.testing.assert_array_equal(tok[row].numpy(), np.asarray(wtok))
        np.testing.assert_array_equal(gate[row].numpy().view(np.uint32),
                                      np.asarray(wgate).view(np.uint32))
        np.testing.assert_array_equal(keep[row].numpy(), np.asarray(wkeep))
    # every kept pair sits in exactly one slot, and its token lists it
    for row in range(b):
        kept = int(keep[row].sum())
        assert int((tok[row] < s).sum()) == kept
        slots = token_slots[row].reshape(-1)
        assert int((slots < E * cap).sum()) == kept
        for t in range(s):
            for sl in token_slots[row, t].tolist():
                if sl < E * cap:
                    assert int(tok[row].reshape(-1)[sl]) == t
        assert bool((token_slots[row][:, 1:] >= token_slots[row][:, :-1]).all())
    # an unbatched (S, k) operand gives the row's tables
    one = M._dispatch_row(torch.from_numpy(ei[1]), torch.from_numpy(gv[1]), E, cap)
    assert all(torch.equal(a, b_[1]) for a, b_ in zip(one, (tok, gate, keep, token_slots)))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_gradients_match_jax(kind):
    rcfg, pcfg = _cfgs(4, 2, 1.0, kind)  # tight capacity: drops on the path too
    rp, pp = _weights(rcfg, seed=1)
    x = _x((2, 12, 32), seed=1)

    def ref_loss(p, xx):
        y, m = RMOE.moe_apply(p, xx, rcfg)
        return jnp.sum(y**2) + m["moe_aux"] + m["moe_z"]

    rg, rgx = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, m = M.moe_apply(leaves, xt, pcfg)
    loss = torch.sum(y**2) + m["moe_aux"] + m["moe_z"]
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names] + [xt])
    assert float(m["moe_drop_frac"]) > 0.0
    for name, g in zip(names + ["x"], grads):
        want = np.asarray(rgx if name == "x" else rg[name])
        assert float(np.abs(want).max()) > 0.0, name
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def _dense_oracle(p, x, cfg):
    """Every expert on every token, weighted by the normalized top-k gates."""
    e = cfg.moe
    probs = torch.softmax(x @ p["router"], -1)
    gv, ei = torch.topk(probs, e.top_k, -1)
    gv = gv / gv.sum(-1, keepdim=True)
    outs = []
    for w in range(e.n_experts):
        h = torch.nn.functional.silu(x @ p["gate"][w]) * (x @ p["up"][w])
        outs.append(h @ p["down"][w])
    allout = torch.stack(outs, -2)                                   # (B, S, E, d)
    sel = torch.take_along_dim(allout, ei[..., None], -2)
    return (sel * gv[..., None]).sum(-2)


def _port(E, k, cf, seed=0, d=32):
    rcfg, pcfg = _cfgs(E, k, cf, d=d)
    return _weights(rcfg, seed)[1], pcfg


@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (8, 4), (16, 4), (32, 8)])
def test_matches_dense_oracle_without_drops(E, k):
    p, cfg = _port(E, k, float(E))
    x = torch.from_numpy(_x((3, 16, 32), seed=E + k))
    y, m = M.moe_apply(p, x, cfg)
    assert float(m["moe_drop_frac"]) == 0.0
    torch.testing.assert_close(y, _dense_oracle(p, x, cfg), rtol=0, atol=1e-4)


def test_capacity_drops_are_bounded():
    p, cfg = _port(4, 2, 0.5)
    x = torch.from_numpy(_x((2, 64, 32)))
    _, m = M.moe_apply(p, x, cfg)
    drop = float(m["moe_drop_frac"])
    cap = round(64 * 2 / 4 * 0.5)
    assert 0.0 <= drop <= 1.0
    assert drop >= 1.0 - (4 * cap) / (64 * 2) - 1e-6


def test_aux_loss_uniform_routing_lower_bound():
    p, cfg = _port(8, 2, 8.0, seed=3)
    _, m = M.moe_apply(p, torch.from_numpy(_x((2, 32, 32))), cfg)
    assert float(m["moe_aux"]) / cfg.moe.aux_loss_weight >= cfg.moe.top_k * 0.999


@hypothesis.settings(max_examples=10, deadline=None)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), E=st.sampled_from([4, 8]),
                  k=st.sampled_from([1, 2]))
def test_property_gate_weighted_conservation(seed, E, k):
    p, cfg = _port(E, k, float(E), seed=seed % 1000)
    x = torch.from_numpy(np.random.RandomState(seed).randn(2, 8, 32).astype(np.float32))
    y, m = M.moe_apply(p, x, cfg)
    assert bool(torch.isfinite(y).all())
    assert float(m["moe_drop_frac"]) == 0.0


def _dispatch_oracle(ei, gv, E, cap):
    """Stable sort by expert, slot bases by searchsorted on the sorted keys."""
    s, k = ei.shape
    fe, ft, fg = ei.reshape(-1), np.repeat(np.arange(s), k), gv.reshape(-1)
    order = np.argsort(fe, kind="stable")
    se, st_, sg = fe[order], ft[order], fg[order]
    within = np.arange(se.size) - np.searchsorted(se, np.arange(E))[se]
    keep = within < cap
    slot = (se * cap + within)[keep]
    slot_token = np.full(E * cap, s, np.int64)
    slot_token[slot] = st_[keep]
    slot_gate = np.zeros(E * cap, np.float32)
    slot_gate[slot] = sg[keep]
    return slot_token.reshape(E, cap), slot_gate.reshape(E, cap), keep


@pytest.mark.parametrize("backend", ["torch", "mma_torch"])
def test_dispatch_offsets_match_searchsorted_oracle(backend):
    E, k, cap, s = 8, 2, 7, 33
    rng = np.random.default_rng(0)
    ei = rng.integers(0, E, size=(s, k))
    gv = rng.random((s, k)).astype(np.float32)
    tok, gate, keep, _ = M._dispatch_row(torch.from_numpy(ei), torch.from_numpy(gv), E, cap,
                                         backend=backend)
    wtok, wgate, wkeep = _dispatch_oracle(ei, gv, E, cap)
    np.testing.assert_array_equal(tok.numpy(), wtok)
    np.testing.assert_array_equal(gate.numpy().view(np.uint32), wgate.view(np.uint32))
    np.testing.assert_array_equal(keep.numpy(), wkeep)


def test_moe_output_bitwise_invariant_to_scan_backend(monkeypatch):
    """The prefix only makes integer slot bases: whichever backend computes
    it, no token moves and the output keeps every bit. The scan site alone
    is pinned; a kernel backend of the flags maps to mma_torch."""
    p, cfg = _port(4, 2, 1.0)
    x = torch.from_numpy(_x((2, 32, 32)))
    orig = M._dispatch_row
    outs = []
    for bk in (None, "torch", "mma_torch"):
        monkeypatch.setattr(M, "_dispatch_row",
                            lambda ei, gv, E, cap, backend=None, _bk=bk: orig(ei, gv, E, cap,
                                                                             backend=_bk))
        y, m = M.moe_apply(p, x, cfg)
        outs.append((y, float(m["moe_drop_frac"])))
    base, base_drop = outs[0]
    assert base_drop > 0.0
    for y, drop in outs[1:]:
        assert torch.equal(y.view(torch.int32), base.view(torch.int32)) and drop == base_drop
    assert M.scan_backend(cfg) == "mma_torch"
    assert M.scan_backend(dataclasses.replace(cfg, mma_reductions=False)) == "torch"


def test_scan_backend_pins_kernel_backends_to_mma_torch():
    from repro_torch import reduce as R

    cfg = get_arch("granite-moe-1b-a400m", tiny=True)
    R.set_default_backend("cuda_fused")
    try:
        assert M.scan_backend(cfg) == "mma_torch"
    finally:
        R.set_default_backend(None)


def test_capacity_is_the_reference_expression():
    for arch in ("granite-moe-1b-a400m", "dbrx-132b"):
        cfg = get_arch(arch)
        assert M.capacity(1, cfg) == 1  # decode
    granite = get_arch("granite-moe-1b-a400m")
    assert M.capacity(256, granite) == 80 and M.capacity(512, granite) == 160
    # Python's round, half to even: 2 x 1 / 4 x 1.25 = 0.625 -> 1; 10 -> 3.125 -> 3
    tiny = dataclasses.replace(granite, moe=MoEConfig(4, 1, 8, capacity_factor=2.5))
    assert [M.capacity(s, tiny) for s in (1, 2, 3, 5)] == [1, 1, 2, 3]


@pytest.mark.parametrize("mma", [True, False], ids=["mma", "plain"])
def test_softmax_mma_matches_reference(mma):
    s = _x((3, 5, 40)) * 4
    want = np.asarray(RL.softmax_mma(jnp.asarray(s), mma=mma))
    got = L.softmax_mma(torch.from_numpy(s), mma=mma).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # another axis takes the plain sum on both sides
    want1 = np.asarray(RL.softmax_mma(jnp.asarray(s), mma=mma, axis=1))
    got1 = L.softmax_mma(torch.from_numpy(s), mma=mma, axis=1).numpy()
    np.testing.assert_allclose(got1, want1, rtol=1e-6, atol=1e-7)


def test_gather_combine_adds_in_segment_sum_order():
    """The combine gathers each token's kept slots and adds them in
    ascending slot order, one add at a time: at bf16, where every add
    rounds, it equals the reference's ``segment_sum`` over the slots
    bitwise (no atomics: the same order on every run)."""
    E, k, s, cap, d = 8, 4, 32, 12, 64  # 16 pairs an expert on average: drops
    rng = np.random.default_rng(0)
    for _ in range(5):
        ei = np.stack([rng.permutation(E)[:k] for _ in range(s)])
        gv = rng.random((s, k)).astype(np.float32)
        tok, _, keep, token_slots = M._dispatch_row(torch.from_numpy(ei[None]),
                                                    torch.from_numpy(gv[None]), E, cap)
        assert not bool(keep.all())  # some pairs dropped
        y = (rng.standard_normal((1, E * cap, d)) * 3).astype(jnp.bfloat16)
        want = jax.ops.segment_sum(jnp.asarray(y[0]), jnp.asarray(tok.reshape(-1).numpy()),
                                   num_segments=s + 1)[:s]
        got = M._Combine.apply(tensor_from_numpy(y), token_slots, tok)[0]
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))

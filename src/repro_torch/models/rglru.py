"""RG-LRU recurrent block (Griffin / RecurrentGemma). [arXiv:2402.19427]

Port of ``repro/models/rglru.py`` (``rglru_init``, ``_block_diag``,
``_gates``, ``rglru_train(return_state=)``, ``make_rglru_cache``,
``rglru_decode``). Two branches from the residual stream,

  gate branch:      linear(d -> w) -> GELU (tanh form, ``jax.nn.gelu``'s
                    default)
  recurrent branch: linear(d -> w) -> causal conv1d -> RG-LRU

merged by an elementwise product, then linear(w -> d). Per channel:

  r_t = sigmoid(block_diag_a(u_t)), i_t = sigmoid(block_diag_x(u_t))
  a_t = exp(-c softplus(lam) r_t)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

The recurrence h_t = a_t h_{t-1} + b_t is a first-order NON-uniform scan:
it has no all-ones-MMA encoding (the scan kernel, K9, sums a stream), so
it runs as ``associative_scan``, a log-depth scan of torch ops over the
sequence with ``jax.lax.associative_scan``'s odd/even recursion and the
combine (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2): about 2 log2(L) levels
of a few elementwise launches each, never a loop over L.

``lam`` and the recurrent state ``h`` are f32 whatever ``cfg.dtype``.

In sharded serving (``sv=``, a ``models.parallel.Serve``) ``h`` and the
conv window hold the rank's channels: under tensor parallelism (``tp``)
its weights are those channels' and out is row-parallel; with whole
weights the rank runs its channels' columns (whole gate blocks) and the
products h * gate are gathered over "model" in rank order before the
whole out.

The decode step returns NEW ``conv`` and ``h`` tensors and leaves the
cache it was given untouched, as ``models.ssm.ssm_decode`` does: the
serving runtime re-issues a failed or poisoned step from the committed
state, which an in-place update would have applied once already.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import params as P

N_GATE_BLOCKS = 16


def _width(cfg) -> int:
    return (cfg.rglru.lru_width or cfg.d_model) if cfg.rglru else cfg.d_model


def rglru_init(gen, cfg, dtype, device) -> dict:
    """The projections in_x, in_gate (d -> w) and out (w -> d), the conv
    weight (K, w), the block-diagonal gate weights (16, w/16, w/16) and
    ``lam`` (f32, the inverse softplus that puts a^(1/r) in [0.9, 0.999],
    Griffin's appendix), drawn from ``gen`` in that order."""
    w, d, r = _width(cfg), cfg.d_model, cfg.rglru
    bs = w // N_GATE_BLOCKS
    params = {
        "in_x": P.dense_init(gen, d, w, dtype, device),
        "in_gate": P.dense_init(gen, d, w, dtype, device),
        "out": P.dense_init(gen, w, d, dtype, device),
        "conv_w": P._normal(gen, (r.conv_width, w), r.conv_width**-0.5, dtype, device),
        "gate_a": P._normal(gen, (N_GATE_BLOCKS, bs, bs), bs**-0.5, dtype, device),
        "gate_x": P._normal(gen, (N_GATE_BLOCKS, bs, bs), bs**-0.5, dtype, device),
    }
    u = 0.9**2 + (0.999**2 - 0.9**2) * torch.rand(
        (w,), generator=gen, dtype=torch.float32, device=device)
    params["lam"] = torch.log(torch.exp(-torch.log(u) / (2 * r.c)) - 1.0)
    return params


def _block_diag(u: torch.Tensor, wblk: torch.Tensor) -> torch.Tensor:
    """u: (..., w); wblk: (nb, bs, bs) -> (..., w) in u's dtype."""
    nb, bs, _ = wblk.shape
    ub = u.reshape(u.shape[:-1] + (nb, bs))
    return torch.einsum("...nb,nbc->...nc", ub, wblk.to(u.dtype)).reshape(u.shape)


def _gates(p, u: torch.Tensor, cfg):
    """(a, b) of the recurrence, f32: a = exp(-c softplus(lam) r), b =
    sqrt(max(1 - a^2, 1e-12)) i u."""
    r = torch.sigmoid(_block_diag(u, p["gate_a"]).to(torch.float32))
    i = torch.sigmoid(_block_diag(u, p["gate_x"]).to(torch.float32))
    log_a = -cfg.rglru.c * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2 * log_a), 1e-12)) * (
        i * u.to(torch.float32))
    return a, b


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 1: even[0], odd[0], even[1], odd[1], ... (even may hold
    one element more)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], 2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], 1) if even.shape[1] > n else out


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) along axis 1 under (a1, b1), (a2, b2) ->
    (a1 a2, a2 b1 + b2), i.e. h_t = a_t h_{t-1} + b_t from h_{-1} = 0 in
    the second output. The odd/even recursion of
    ``jax.lax.associative_scan``: the same combines in the same order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # adjacent pairs (0, 1), (2, 3), ...
    ra, rb = a[:, 1::2] * a[:, 0:-1:2], a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2]
    oa, ob = associative_scan(ra, rb)  # the scan at positions 1, 3, 5, ...
    # positions 2, 4, ...: the odd prefix before each, then the element
    m = (n - 1) // 2
    ea = a[:, 2::2] * oa[:, :m]
    eb = a[:, 2::2] * ob[:, :m] + b[:, 2::2]
    ea, eb = torch.cat([a[:, :1], ea], 1), torch.cat([b[:, :1], eb], 1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_train(p, x: torch.Tensor, cfg, return_state: bool = False, tp=None, sv=None):
    """The block, train/prefill. x: (B, L, d) -> (B, L, d), or with
    ``return_state`` (out, cache): the conv window (the last K-1 pre-conv
    inputs, zero-filled in front of a short prompt) and the final state
    h_{L-1} (f32), the prefill -> decode handoff. ``tp``
    (``models.parallel.TP``): the channel leaves hold a rank's channels
    (whole gate blocks); x goes through ``tp.enter`` (Megatron's f), every
    op up to h * gate runs on those channels alone, and out is
    row-parallel, its partial sums through ``tp.exit`` (g). ``sv``: the
    sharded prefill (the module doc); the cache returned holds the rank's
    channels."""
    if tp is not None:
        x = tp.enter(x)
    u_raw = P.dense_apply(p["in_x"], x)
    u = L.causal_conv1d(u_raw, p["conv_w"])
    a, b = _gates(p, u, cfg)
    _, h = associative_scan(a, b)
    gate = F.gelu(P.dense_apply(p["in_gate"], x).to(torch.float32), approximate="tanh")
    out = P.dense_apply(p["out"], L.gather_outputs((h * gate).to(x.dtype), sv))
    if tp is not None:
        out = tp.exit(out)
    if not return_state:
        return out
    k = cfg.rglru.conv_width
    tail = F.pad(u_raw, (0, 0, max(0, (k - 1) - x.shape[1]), 0))[:, -(k - 1):]
    return out, {"conv": tail, "h": h[:, -1]}


def make_rglru_cache(batch: int, cfg, dtype, device) -> dict:
    w = _width(cfg)
    return {
        "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w), dtype=dtype, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_decode(p, x_t: torch.Tensor, cache: dict, cfg, tp=None, sv=None):
    """One decode step. x_t: (B, 1, d) -> (out (B, 1, d), a NEW cache): the
    conv window shifted by one and h = a h + b, both new tensors; ``cache``
    is left as it was (see the module doc). ``tp`` and ``sv``: the sharded
    decode, as ``rglru_train``'s."""
    xt = x_t[:, 0]
    u_t = P.dense_apply(p["in_x"], xt)
    conv_state, u_t = L.conv1d_step(cache["conv"], u_t, p["conv_w"])
    a, b = _gates(p, u_t, cfg)
    h = a * cache["h"] + b
    gate = F.gelu(P.dense_apply(p["in_gate"], xt).to(torch.float32), approximate="tanh")
    out = P.dense_apply(p["out"], L.gather_outputs((h * gate).to(x_t.dtype), sv))
    if tp is not None:
        out = tp.exit(out)
    return out[:, None, :], {"conv": conv_state, "h": h}


"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.

Port of ``repro/models/moe.py`` (``moe_init``, ``_dispatch_row``,
``moe_apply``). Each batch row is one routing group: its S tokens route
into (E, C) capacity slots of their own, so the batch's other rows never
move a token (the reference's group-wise routing). The reference vmaps the
per-row dispatch; here every step is batched over the rows.

  route        router logits (f32 activations x the f32 router, never at
               TF32), the softmax with its ones-product denominator, top-k
               and the renormalized gates, the capacity, and the slot
               tables of ``_dispatch_row``
  moe_apply    the dispatch gather into a dense (B, E, C, d) block, the
               expert FFNs as batched products (SwiGLU, or GELU without
               the gate), the gate-weighted combine, and the load-balance
               and router-z statistics

The combine gathers instead of scattering: each token reads the gated
outputs of its kept slots and adds them in ascending slot order (expert
order), one fixed sequence of adds, where the reference's
``segment_sum`` over slots would be ``index_add_`` here, whose adds on the
card are atomics in no fixed order. The dispatch gather's backward is the
same gather-and-sum over a token's slots, and the combine's backward a
gather by the slot table, so no step of the forward or backward pass
depends on the order of atomics: the results are bitwise repeatable.

The slot-base scan (the exclusive prefix of the per-expert counts) stays
where the reference pins it: ``torch`` or ``mma_torch`` as the config flags
give them, any kernel backend mapped to ``mma_torch`` (a scan of E counts
a row; f32 prefixes of integers below 2^24 are exact on every backend).
The routing's row sums (the softmax denominator, the load-balance
statistics) are the engine's row reductions: on every backend a
ones-product in torch, no kernel launch.

Expert parallelism (``moe_apply(ep=)``, ``models.parallel.EP``): the
leading E axis of every expert weight carries the "experts" axis, cut over
"model". Every rank of a model group holds the same tokens, so each routes
them alike (the router is whole on every rank), keeps the slot tables of
its own E / model experts, runs those experts, and adds its gate-weighted
combine's partial token sums to the others' over "model" in rank order
(the reference's psum at the end of its shard_map dispatch). The tokens
enter the dispatch, and the gates the tables, through ``sum_backward``:
each rank's experts see their own slots, so their gradients add over
"model", while the aux losses, which every rank takes alike from the whole
routing, do not. The load-balance statistics are sums over the whole
batch: each rank's over its rows, then summed over the batch axes
(``sum_both``). The degrees come from the ``Plan``'s ``EP``.

The reference chooses between two dispatch routes, its shard_map dispatch
and the one that constrains the (E, C, d) block to the mesh
(``USE_SHARD_MAP_DISPATCH``, with ``_data_degree`` and ``_model_degree``
reading the mesh for it). Here, with a process a rank, both are the one
rank-local dispatch above, so the switch and its two helpers have no
counterpart.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import reduce as R
from repro_torch.core import collectives as C
from repro_torch.models import context as CTX
from repro_torch.models import layers as L
from repro_torch.models import params as P


def moe_init(gen, cfg, dtype, device) -> dict:
    """The f32 router (d, E) and the stacked expert weights, (E, d, f) for
    gate and up, (E, f, d) for down, drawn from ``gen`` in that order; the
    GELU experts have no gate."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    params = {"router": P._normal(gen, (d, e.n_experts), d**-0.5, torch.float32, device)}
    if cfg.ffn_kind == "swiglu":
        params["gate"] = P._normal(gen, (e.n_experts, d, f), d**-0.5, dtype, device)
    params["up"] = P._normal(gen, (e.n_experts, d, f), d**-0.5, dtype, device)
    params["down"] = P._normal(gen, (e.n_experts, f, d), f**-0.5, dtype, device)
    return params


def capacity(s: int, cfg) -> int:
    """Slots per expert in a group of ``s`` tokens, the reference's
    expression (Python's round, half to even): 1 at decode for both MoE
    archs."""
    e = cfg.moe
    return int(max(1, round(s * e.top_k / e.n_experts * e.capacity_factor)))


def _dispatch_row(expert_ix, gate_vals, n_experts: int, cap: int, backend=None):
    """Routed pairs (..., S, k) -> slot tables, every leading row its own
    group: ``slot_token`` (..., E, C) int64 (S marks an empty slot),
    ``slot_gate`` (..., E, C) f32 (0 in an empty slot), ``keep`` (..., S k)
    in the stable expert order of the pairs, and ``token_slots`` (..., S,
    k): each token's slots in ascending order, E C for a dropped pair.

    A stable sort of the flat expert ids, the per-expert counts, their
    exclusive prefix through the engine's scan on ``backend``, ``within <
    cap``. The tables are filled by gathers: slot (e, c) holds the pair at
    sorted position start[e] + c when c < counts[e]."""
    lead = expert_ix.shape[:-2]
    s, k = expert_ix.shape[-2:]
    b = math.prod(lead)
    dev = expert_ix.device
    flat_expert = expert_ix.reshape(b, s * k).to(torch.int64)
    order = torch.sort(flat_expert, dim=-1, stable=True).indices
    se = torch.gather(flat_expert, 1, order)
    st = order // k  # the token of each sorted pair
    sg = torch.gather(gate_vals.reshape(b, s * k).to(torch.float32), 1, order)
    counts = F.one_hot(se, n_experts).sum(1)                          # (b, E)
    start = R.scan(counts.to(torch.float32), inclusive=False,
                   backend=backend).to(torch.int64)
    within = torch.arange(s * k, device=dev) - torch.gather(start, 1, se)
    keep = within < cap
    # slot tables: slot (e, c) <- sorted position start[e] + c, if filled
    c = torch.arange(cap, device=dev)
    filled = c[None, None, :] < counts[:, :, None]                   # (b, E, C)
    pos = torch.clamp(start[:, :, None] + c, max=s * k - 1).reshape(b, -1)
    slot_token = torch.where(filled, torch.gather(st, 1, pos).view(b, n_experts, cap), s)
    slot_gate = torch.where(filled, torch.gather(sg, 1, pos).view(b, n_experts, cap), 0.0)
    # each pair's slot (E C: dropped), back in (token, choice) order, then
    # each token's slots ascending
    slot = torch.where(keep, se * cap + within, n_experts * cap)
    pair_slot = torch.empty_like(slot).scatter_(1, order, slot)      # a permutation
    token_slots = torch.sort(pair_slot.view(b, s, k), dim=-1).values
    out = (slot_token, slot_gate, keep, token_slots)
    return tuple(t.reshape(lead + t.shape[1:]) for t in out)


def _sum_slots(rows: torch.Tensor, token_slots: torch.Tensor) -> torch.Tensor:
    """rows (B, N + 1, d), the last a zero row; token_slots (B, S, k) of
    row indices ascending (N: none) -> (B, S, d): each token's rows added
    in that order, one add at a time."""
    b, s, k = token_slots.shape
    d = rows.shape[-1]
    picked = torch.gather(rows, 1, token_slots.reshape(b, s * k, 1).expand(-1, -1, d))
    picked = picked.view(b, s, k, d)
    acc = picked[:, :, 0]
    for j in range(1, k):
        acc = acc + picked[:, :, j]
    return acc


def _gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) with a zero row appended, rows picked by index (B, N)
    (S: the zero row) -> (B, N, d)."""
    xpad = F.pad(x, (0, 0, 0, 1))
    return torch.gather(xpad, 1, index.unsqueeze(-1).expand(-1, -1, x.shape[-1]))


class _Dispatch(torch.autograd.Function):
    """Forward: slot (e, c) of row b reads token slot_token[b, e, c] (the
    zero row when empty). Backward: each token adds the gradients of its
    kept slots in ascending order (``_sum_slots``), no atomics."""

    @staticmethod
    def forward(ctx, x, slot_token, token_slots):
        ctx.save_for_backward(token_slots)
        return _gather_rows(x, slot_token.reshape(x.shape[0], -1))

    @staticmethod
    def backward(ctx, g):
        (token_slots,) = ctx.saved_tensors
        return _sum_slots(F.pad(g, (0, 0, 0, 1)), token_slots), None, None


class _Combine(torch.autograd.Function):
    """Forward: token t adds the outputs of its kept slots in ascending
    order. Backward: slot (e, c) reads the gradient of its token (zero when
    empty) -- the adjoint pair of ``_Dispatch``."""

    @staticmethod
    def forward(ctx, yflat, token_slots, slot_token):
        ctx.save_for_backward(slot_token)
        return _sum_slots(F.pad(yflat, (0, 0, 0, 1)), token_slots)

    @staticmethod
    def backward(ctx, g):
        (slot_token,) = ctx.saved_tensors
        return _gather_rows(g, slot_token.reshape(g.shape[0], -1)), None, None


class Routing(NamedTuple):
    logits: torch.Tensor       # (B, S, E) f32
    probs: torch.Tensor        # (B, S, E) f32
    expert_ix: torch.Tensor    # (B, S, k) int64, top-k descending
    gate_vals: torch.Tensor    # (B, S, k) f32, renormalized
    slot_token: torch.Tensor   # (B, E, C)
    slot_gate: torch.Tensor    # (B, E, C)
    keep: torch.Tensor         # (B, S k)
    token_slots: torch.Tensor  # (B, S, k)


def scan_backend(cfg) -> str:
    """The slot-base scan's backend: the flags' backend when it is
    ``torch`` or ``mma_torch``, else ``mma_torch`` (the reference's pin)."""
    rb = R.backend_for_flags(cfg.mma_reductions)
    return rb if rb in ("torch", "mma_torch") else "mma_torch"


def route(p: dict, x: torch.Tensor, cfg, gate_hook=None) -> Routing:
    """The routing of x (B, S, d): router logits and probabilities, the
    top-k experts and gates, and the slot tables at ``capacity(S)``.
    ``gate_hook`` maps the renormalized gates before the tables take them
    (expert parallelism's ``sum_backward``)."""
    e = cfg.moe
    with L.full_f32_matmul():
        logits = torch.matmul(x.to(torch.float32), p["router"])        # (B, S, E)
        probs = L.softmax_mma(logits, mma=cfg.mma_reductions)
        gate_vals, expert_ix = torch.topk(probs, e.top_k, dim=-1)
        gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
        if gate_hook is not None:
            gate_vals = gate_hook(gate_vals)
        tables = _dispatch_row(expert_ix, gate_vals, e.n_experts, capacity(x.shape[1], cfg),
                               backend=scan_backend(cfg))
    return Routing(logits, probs, expert_ix, gate_vals, *tables)


def _local_slots(token_slots: torch.Tensor, lo: int, hi: int, cap: int) -> torch.Tensor:
    """Each token's slots among experts [lo, hi), renumbered from lo's
    first slot and ascending; (hi - lo) C marks none."""
    n = (hi - lo) * cap
    local = token_slots - lo * cap
    local = torch.where((local >= 0) & (local < n), local, n)
    return torch.sort(local, dim=-1).values


def moe_apply(p: dict, x: torch.Tensor, cfg, ep=None):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, metrics). Capacity-dropped
    pairs add nothing: a token with every pair dropped passes through the
    block's residual unchanged. ``metrics``: ``moe_aux`` (the load-balance
    term times its weight), ``moe_z`` (the router z-loss times its weight)
    and ``moe_drop_frac``. ``ep`` (``models.parallel.EP``): ``p``'s expert
    weights are the rank's experts, and x the rank's rows (module doc)."""
    e = cfg.moe
    b, s, d = x.shape
    tp = None if ep is None else ep.tp
    r = route(p, x, cfg) if tp is None else route(p, x, cfg, gate_hook=tp.enter)
    cap = r.slot_token.shape[-1]
    n_local = p["up"].shape[0]
    slot_token, slot_gate, token_slots = r.slot_token, r.slot_gate, r.token_slots
    xd = x
    if tp is not None:
        lo = ep.e0
        slot_token, slot_gate = slot_token[:, lo:lo + n_local], slot_gate[:, lo:lo + n_local]
        token_slots = _local_slots(token_slots, lo, lo + n_local, cap)
        xd = tp.enter(x)
    gathered = _Dispatch.apply(xd, slot_token, token_slots).view(b, n_local, cap, d)
    gathered = CTX.constrain_moe_dispatch(gathered, e.n_experts)
    # ---- expert FFNs as batched products ----
    up = torch.einsum("becd,edf->becf", gathered, p["up"].to(x.dtype))
    if cfg.ffn_kind == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", gathered, p["gate"].to(x.dtype))) * up
    else:
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default form
    yexp = torch.einsum("becf,efd->becd", h, p["down"].to(x.dtype))
    # ---- gate-weighted combine back to tokens ----
    # the gate is cast to the activation dtype before the multiply
    yflat = (yexp * slot_gate[..., None].to(yexp.dtype)).reshape(b, -1, d)
    y = _Combine.apply(yflat, token_slots, slot_token)
    if tp is not None:
        y = tp.exit(y)  # the ranks' partial token sums, in rank order
    # ---- aux statistics: both per-expert sums over all B S tokens in one
    # row pass of the engine (over the batch axes, summed across them) ----
    counts = F.one_hot(r.expert_ix, e.n_experts).to(torch.float32).sum(2)   # (B, S, E)
    t = b * s
    tpe_sum, prob_sum = R.reduce_many(
        [counts.movedim(-1, 0).reshape(e.n_experts, -1),
         r.probs.movedim(-1, 0).reshape(e.n_experts, -1)],
        axis=-1, backend=R.backend_for_flags(cfg.mma_reductions),
    )
    if ep is not None and ep.batch:
        both = C.sum_both(torch.stack([tpe_sum, prob_sum]), ep.batch, ep.mesh)
        tpe_sum, prob_sum = both[0], both[1]
        t = t * ep.data_degree
    aux = e.n_experts * torch.sum((tpe_sum / t) * (prob_sum / t))
    zloss = torch.mean(torch.logsumexp(r.logits, -1) ** 2)
    metrics = {
        "moe_aux": aux * e.aux_loss_weight,
        "moe_z": zloss * e.router_z_weight,
        "moe_drop_frac": 1.0 - r.keep.sum().to(torch.float32) / r.keep.numel(),
    }
    return y.to(x.dtype), metrics

"""Attention: projections, the two train/prefill routes, KV caches and
decode, local attention's ring caches, and cross-attention.

Port of ``repro/models/attention.py``: causal self-attention, global or
within a window (``window=``: keys less than ``window`` positions behind),
and the vision layers' gated cross-attention.
Activations keep the reference's (B, S, H, D) layout; the kernel takes
(B, H, S, D), as the reference's does.

  train and prefill: ``self_attention_train`` runs, with ``use_kernels``,
           ``kernels.flash_attention_diff`` -- the kernel forward,
           differentiable by dense recompute -- and without it
           ``flash_attention_xla``: q and kv tiled into chunks with an
           online softmax, O(Sq x kv_chunk) score memory, each kv chunk
           under ``torch.utils.checkpoint`` (the reference's
           ``jax.checkpoint``: the backward pass recomputes each score tile
           instead of keeping every one of every layer).
  decode:  ``self_attention_decode`` writes the new K/V into the cache and
           runs ``decode_attention``.
  cross:   ``cross_attention_apply`` runs ``flash_attention_xla`` with
           ``causal=False`` on both routes (the reference's: its
           cross-attention never takes the kernel), times tanh(gate).

Both non-kernel routes multiply bf16-rounded operands with f32
accumulation, as the reference's einsums do, and take the softmax
denominator as a row sum of ``repro_torch.reduce`` on
``backend_for_flags(mma)``: the ones-MMA route with the paper's technique
on, plain ``torch`` with it off; the steps pass ``mma=cfg.mma_reductions``.

KV caches are written IN PLACE (the reference's are immutable arrays). The
serving runtime may retry a decode step from its committed state; the step
at position p writes slot p and then reads slots <= p, so a retry rewrites
that slot with the same values before reading it: the in-place write is
idempotent under retry, and a retried step reproduces the clean step
bitwise (tests/test_torch_serve.py checks both). A local-attention layer's
cache is a RING of min(s_max, window) slots: position p lives at slot p %
slots (``fill_kv_cache`` keeps a long prompt's last positions there), and
the decode step at p overwrites the slot of position p - slots, which no
query from p on may see (p - (p - slots) >= window). A retried step
rewrites that slot with the same values again, so the argument above holds
for the ring too (tests/test_torch_local_attention.py).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels as K
from repro_torch.kernels.common import bf16_round
from repro_torch import reduce as R
from repro_torch.models import layers as L
from repro_torch.models import params as P

NEG = -1e30


def attn_init(gen, d: int, n_heads: int, n_kv: int, d_head: int, dtype, device) -> dict:
    return {
        "q": P.dense_init(gen, d, n_heads * d_head, dtype, device),
        "k": P.dense_init(gen, d, n_kv * d_head, dtype, device),
        "v": P.dense_init(gen, d, n_kv * d_head, dtype, device),
        "o": P.dense_init(gen, n_heads * d_head, d, dtype, device,
                          scale=(n_heads * d_head) ** -0.5),
    }


def _project_qkv(p, x, d_head):
    """q, k, v (B, S, heads, d_head) with as many heads as the weights
    hold: the model's, or a tensor-parallel rank's own."""
    b, s, _ = x.shape
    q = P.dense_apply(p["q"], x).reshape(b, s, -1, d_head)
    k = P.dense_apply(p["k"], x).reshape(b, s, -1, d_head)
    v = P.dense_apply(p["v"], x).reshape(b, s, -1, d_head)
    return q, k, v


def _online_block(m, l, acc, qc, kc, vc, qpos, kpos, *, causal, window, kv_len, scale,
                  mma):
    """One (q-chunk, kv-chunk) online-softmax update.

    qc: (B, Hkv, G, Cq, D); kc/vc: (B, Hkv, Ck, D); m, l: (B, Hkv, G, Cq);
    acc: (B, Hkv, G, Cq, Dv)."""
    s = torch.matmul(bf16_round(qc), bf16_round(kc).transpose(-1, -2)[:, :, None]) * scale
    mask = kpos[None, :] < kv_len
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
    s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m, s.amax(-1))
    e = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    esum = R.reduce(e, -1, backend=R.backend_for_flags(mma))
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + esum
    pv = torch.matmul(bf16_round(e), bf16_round(vc)[:, :, None])
    return m_new, l_new, acc * alpha[..., None] + pv


def flash_attention_xla(q, k, v, *, causal: bool = True, window=None, q_offset: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 1024, mma: bool = True,
                        sm_scale=None) -> torch.Tensor:
    """Chunked attention with an online softmax, the reference's non-kernel
    route. q: (B, Sq, H, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv) ->
    (B, Sq, H, Dv) in q's dtype. Query i sits at position ``q_offset + i``;
    ``window`` keeps keys less than ``window`` positions behind."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = sm_scale if sm_scale is not None else d**-0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq = -(-sq // q_chunk)
    nk = -(-skv // kv_chunk)
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - sq))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * kv_chunk - skv))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * kv_chunk - skv))
    qg = qp.reshape(b, nq * q_chunk, hkv, g, d).permute(0, 2, 3, 1, 4)  # (B, Hkv, G, Sq, D)
    kg = kp.permute(0, 2, 1, 3)                                         # (B, Hkv, Skv, D)
    vg = vp.permute(0, 2, 1, 3)
    block = functools.partial(_online_block, causal=causal, window=window, kv_len=skv,
                              scale=scale, mma=mma)
    # inference keeps no tiles for a backward pass: no recompute needed
    step = (functools.partial(checkpoint, block, use_reentrant=False)
            if torch.is_grad_enabled() else block)
    outs = []
    for iq in range(nq):
        qc = qg[:, :, :, iq * q_chunk:(iq + 1) * q_chunk]
        qpos = q_offset + iq * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, hkv, g, q_chunk), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, dv), dtype=torch.float32, device=q.device)
        for ik in range(nk):
            sl = slice(ik * kv_chunk, (ik + 1) * kv_chunk)
            kpos = ik * kv_chunk + torch.arange(kv_chunk, device=q.device)
            m, l, acc = step(m, l, acc, qc, kg[:, :, sl], vg[:, :, sl], qpos, kpos)
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])        # (B, Hkv, G, Cq, Dv)
    out = torch.cat(outs, 3).permute(0, 3, 1, 2, 4).reshape(b, nq * q_chunk, h, dv)
    return out[:, :sq].to(q.dtype)


def _read_kv(k, v, sv, cfg):
    """k and v (B, S, Hkv', D) cut to the kv heads the rank's query heads
    read (``sv``: its ``models.parallel.Serve``; None: all of them)."""
    if sv is None:
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    (q0, q1), c0 = sv.q_heads, sv.cache_heads[0]
    a, z = q0 // g - c0, (q1 - 1) // g + 1 - c0
    return k[:, :, a:z], v[:, :, a:z]


def _out(p, out, tp, sv):
    """The head outputs (B, S, H' D) through o: gathered over the model
    ranks first where ``sv`` says so (o whole, the rank holding some of the
    heads); under ``tp`` the rank's rows of o, then Megatron's g."""
    out = P.dense_apply(p["o"], L.gather_outputs(out, sv))
    return out if tp is None else tp.exit(out)


def self_attention_train(p, x, positions, cfg, *, window=None, return_kv=False, tp=None,
                         sv=None):
    """(B, S, d) -> (B, S, d): causal self-attention, train/prefill path,
    on the kernel with ``cfg.use_kernels`` (its window mask; past heads of
    128 the kernel's wide variant) and on ``flash_attention_xla`` without
    it; ``window`` keeps the keys less than ``window`` positions behind.
    ``return_kv=True`` also returns the RoPE'd keys and the values (B, S,
    Hkv, D) -- what the prefill writes into the cache. ``tp``
    (``models.parallel.TP``): the weights hold a rank's heads, q/k/v are
    column-parallel (x through ``tp.enter``) and o row-parallel (its
    partial sums through ``tp.exit``). ``sv`` (``models.parallel.Serve``,
    the sharded prefill): q holds the rank's query heads and k/v its
    cache's kv heads; the rank attends its query heads, and its head
    outputs are gathered for a whole o where ``sv.gather_heads``."""
    if tp is not None:
        x = tp.enter(x)
    q, k, v = _project_qkv(p, x, cfg.d_head)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    ka, va = _read_kv(k, v, sv, cfg)
    if cfg.use_kernels:
        out = K.flash_attention_diff(
            q.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2), True, window, 0, None
        ).transpose(1, 2)
    else:
        out = flash_attention_xla(q, ka, va, causal=True, window=window, mma=cfg.mma_reductions)
    b, s = out.shape[0], out.shape[1]
    out = _out(p, out.reshape(b, s, -1), tp, sv)
    return (out, k, v) if return_kv else out


def make_kv_cache(batch: int, s_max: int, n_kv: int, d_head: int, dtype, device) -> dict:
    return {
        "k": torch.zeros((batch, s_max, n_kv, d_head), dtype=dtype, device=device),
        "v": torch.zeros((batch, s_max, n_kv, d_head), dtype=dtype, device=device),
        "slot_pos": torch.full((s_max,), -1, dtype=torch.int32, device=device),
    }


def fill_kv_cache(cache: dict, k: torch.Tensor, v: torch.Tensor, slot0: int = 0) -> dict:
    """Prefill: the prompt's RoPE'd keys and values into the cache, in
    place. A prompt that fits goes to slots [0, S); a longer one into a
    ring (local attention) keeps its last s_max positions, position p at
    slot p % s_max, so that later decode writes (slot pos % s_max) evict
    the oldest first -- the reference's ring branch. ``slot0``: a cache
    that holds the block of slots from ``slot0`` on (a rank's, the cache
    cut by slots) gets its slots of the prompt (of a ring, the positions
    whose slots p % s_max are its own); ``slot_pos`` is whole on
    every rank and written whole."""
    s = k.shape[1]
    s_max, n = cache["slot_pos"].shape[0], cache["k"].shape[1]
    if s <= s_max:
        n = max(0, min(s - slot0, n))
        cache["k"][:, :n] = k[:, slot0:slot0 + n]
        cache["v"][:, :n] = v[:, slot0:slot0 + n]
        cache["slot_pos"][:s] = torch.arange(s, dtype=torch.int32, device=k.device)
        return cache
    tail = torch.arange(s - s_max, s, device=k.device)
    slots = tail % s_max
    mine = (slots >= slot0) & (slots < slot0 + n)
    cache["k"][:, slots[mine] - slot0] = k[:, -s_max:][:, mine]
    cache["v"][:, slots[mine] - slot0] = v[:, -s_max:][:, mine]
    cache["slot_pos"][slots] = tail.to(torch.int32)
    return cache


def decode_attention_partial(q, k_cache, v_cache, slot_pos, pos: int, *, window=None,
                             mma: bool = True, sm_scale=None):
    """The partial softmax of one decode query over the slots given:
    q (B, 1, H, D), RoPE'd; caches (B, S, Hkv, D); slot_pos (S,) absolute
    position per slot (-1 empty). -> (m (B, Hkv, G, 1), the slots' max
    score; denom (B, Hkv, G), the sum of exp(score - m); out (B, Hkv, G,
    Dv), the unnormalised exp-weighted values), all f32. A block of slots
    with none visible gives m = -1e30, denom 0, out 0."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    scale = sm_scale if sm_scale is not None else d**-0.5
    qg = bf16_round(q.reshape(b, hkv, g, d))
    s = torch.matmul(qg, bf16_round(k_cache).permute(0, 2, 3, 1)) * scale  # (B,Hkv,G,S)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid = valid & ((pos - slot_pos) < window)
    s = torch.where(valid, s, NEG)
    m = s.amax(-1, keepdim=True)
    e = torch.where(valid, torch.exp(s - m), 0.0)
    denom = R.reduce(e, -1, backend=R.backend_for_flags(mma))
    out = torch.matmul(bf16_round(e), bf16_round(v_cache).permute(0, 2, 1, 3))
    return m, denom, out


def merge_decode_partials(parts: list) -> torch.Tensor:
    """Several blocks of slots' ``decode_attention_partial`` triples, in
    order, merged into the normalised output (B, Hkv, G, Dv) f32: M = max
    m_r, denominator sum_r e^(m_r - M) d_r, output sum_r e^(m_r - M) o_r
    over the denominator, each sum a left fold in the order given."""
    big = parts[0][0]
    for m, _, _ in parts[1:]:
        big = torch.maximum(big, m)
    denom = out = None
    for m, dn, o in parts:
        w = torch.exp(m - big)
        denom = w[..., 0] * dn if denom is None else denom + w[..., 0] * dn
        out = w * o if out is None else out + w * o
    return out / torch.clamp_min(denom, 1e-30)[..., None]


def decode_attention(q, k_cache, v_cache, slot_pos, pos: int, *, window=None,
                     mma: bool = True, sm_scale=None) -> torch.Tensor:
    """q: (B, 1, H, D), RoPE'd; caches (B, Smax, Hkv, D); slot_pos (Smax,)
    absolute position per slot (-1 empty); ``window`` keeps the slots less
    than ``window`` positions behind ``pos``. Products of bf16-rounded
    operands accumulate in f32, as the reference's einsums do; ``mma``
    picks the denominator's reduce backend (``backend_for_flags(mma)``).
    The one-block case of ``decode_attention_partial``: its output over
    its denominator."""
    b, _, h, _ = q.shape
    _, denom, out = decode_attention_partial(q, k_cache, v_cache, slot_pos, pos, window=window,
                                             mma=mma, sm_scale=sm_scale)
    out = out / torch.clamp_min(denom, 1e-30)[..., None]
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


def _split_kv_decode(q, k, v, slot_pos, pos: int, cfg, sv, window):
    """The split-KV decode of a cache cut by slots (``models.parallel``'s
    module doc): q gathered over "model" where the rank holds some of the
    query heads, the partial softmax of every query head over the rank's
    slots (k, v and their positions ``slot_pos``), the partials merged
    over "model" in rank order, the rank's heads taken. -> (B, 1, H',
    Dv)."""
    b = q.shape[0]
    if sv.q_heads != (0, cfg.n_heads):
        q = sv.gather(q, 2)  # every query head reads every rank's slots
    m, denom, o = decode_attention_partial(q, k, v, slot_pos, pos, window=window,
                                           mma=cfg.mma_reductions)
    out = merge_partials(sv, m, denom, o)
    out = out.reshape(b, 1, cfg.n_heads, o.shape[-1])
    return out[:, :, sv.q_heads[0]:sv.q_heads[1]].to(q.dtype)


def merge_partials(sv, m, denom, o) -> torch.Tensor:
    """Every model rank's partial softmax (m (..., 1), denom (...), o (...,
    Dv)) gathered over ``sv``'s axis and merged in rank order
    (``merge_decode_partials``): the normalised output (..., Dv) f32."""
    rows = sv.rows(torch.cat([m, denom[..., None], o], -1))
    return merge_decode_partials([(r[..., :1], r[..., 1], r[..., 2:]) for r in rows])


def self_attention_decode(p, x_t, cache, pos: int, cfg, *, window=None, tp=None, sv=None):
    """One decode step at absolute position ``pos``. x_t: (B, 1, d). Writes
    K/V at slot ``pos % s_max`` of the cache in place (see the module doc):
    slot ``pos`` of a full cache, or the rotating slot of a local
    attention's ring (``window`` given), which evicts the oldest key.
    Returns (out (B, 1, d), cache).

    ``tp`` and ``sv``: the sharded decode (``self_attention_train``'s).
    Only the rank whose cache holds the slot writes the new key and value
    (``slot_pos`` is whole and written on every rank); a cache cut by
    slots attends through ``_split_kv_decode``."""
    b = x_t.shape[0]
    q, k, v = _project_qkv(p, x_t, cfg.d_head)
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=x_t.device)
    q = L.rope(q, posb, cfg.rope_theta)
    k = L.rope(k, posb, cfg.rope_theta)
    s_max = cache["slot_pos"].shape[0]
    if pos >= s_max and (window is None or s_max < window):
        # a full cache, or a ring shorter than the window, would evict a
        # key the query still sees
        raise ValueError(f"decode position {pos} is past the cache length {s_max}")
    slot = pos % s_max
    lo = 0 if sv is None else sv.slots[0]
    if lo <= slot < lo + cache["k"].shape[1]:
        cache["k"][:, slot - lo] = k[:, 0]
        cache["v"][:, slot - lo] = v[:, 0]
    cache["slot_pos"][slot] = pos
    if sv is not None and sv.cache == "seq":
        mine = cache["slot_pos"][lo:lo + cache["k"].shape[1]]
        out = _split_kv_decode(q, cache["k"], cache["v"], mine, pos, cfg, sv, window)
    else:
        kc, vc = _read_kv(cache["k"], cache["v"], sv, cfg)
        out = decode_attention(q, kc, vc, cache["slot_pos"], pos, window=window,
                               mma=cfg.mma_reductions)
    return _out(p, out.reshape(b, 1, -1), tp, sv), cache


def cross_attention_init(gen, d: int, n_heads: int, n_kv: int, d_head: int, dtype,
                         device) -> dict:
    """``attn_init``'s q, k, v, o and a 0-d tanh gate at the parameters'
    dtype, zero at init (Llama-3.2-vision): a new model's cross-attention
    adds nothing until the gate is trained away from 0."""
    p = attn_init(gen, d, n_heads, n_kv, d_head, dtype, device)
    p["gate"] = torch.zeros((), dtype=dtype, device=device)
    return p


def cross_kv(p, ctx, cfg):
    """The context's keys and values (B, N, Hkv, D), not RoPE'd: what the
    prefill keeps in a cross-attention layer's cache; as many kv heads as
    the weights hold (a tensor-parallel rank's own)."""
    b, n, _ = ctx.shape
    k = P.dense_apply(p["k"], ctx).reshape(b, n, -1, cfg.d_head)
    v = P.dense_apply(p["v"], ctx).reshape(b, n, -1, cfg.d_head)
    return k, v


def _gated(p, out):
    return torch.tanh(p["gate"].to(torch.float32)).to(out.dtype) * out


def cross_attention_apply(p, x, ctx, cfg, tp=None, sv=None):
    """x: (B, S, d) queries; ctx: (B, N, d) the frontend's embeddings, read
    as they come (no norm). tanh(gate) o(attn(q(x), k(ctx), v(ctx))), no
    RoPE, on the chunked ``flash_attention_xla`` (``causal=False``) on both
    routes, as the reference runs it. -> (B, S, d). ``tp``
    (``models.parallel.TP``): q, k and v hold a rank's heads and the kv
    heads they read, x goes through ``tp.enter`` (the context, an input
    with no gradient, needs none), o is row-parallel with ``tp.exit``, and
    the whole gate multiplies after it. ``sv`` (the sharded prefill): as
    ``self_attention_train``'s."""
    b, s, _ = x.shape
    if tp is not None:
        x = tp.enter(x)
    q = P.dense_apply(p["q"], x).reshape(b, s, -1, cfg.d_head)
    k, v = _read_kv(*cross_kv(p, ctx, cfg), sv, cfg)
    out = flash_attention_xla(q, k, v, causal=False, mma=cfg.mma_reductions)
    return _gated(p, _out(p, out.reshape(b, s, -1), tp, sv))


def fill_cross_cache(cache: dict, k: torch.Tensor, v: torch.Tensor, sv=None) -> dict:
    """Prefill: the context's keys and values (B, N, Hkv', D) into a
    cross-attention cache, in place: all of them, or (``sv``, a cache cut
    by image tokens) the rank's tokens. Under a ``Serve`` cut by heads
    the weights already gave the rank's kv heads."""
    if sv is not None and sv.cache == "seq":
        lo, hi = sv.slots
        k, v = k[:, lo:hi], v[:, lo:hi]
    cache["k"].copy_(k)
    cache["v"].copy_(v)
    return cache


def cross_attention_decode(p, x_t, cache, cfg, tp=None, sv=None):
    """One decode step of a cross-attention layer: x_t's query against all
    N cached context slots (``decode_attention`` at slot positions 0..N-1,
    every one visible), times tanh(gate). The cache is only read. ``tp``
    and ``sv``: the sharded decode (``self_attention_decode``'s); a cache
    cut by image tokens attends through ``_split_kv_decode``, every one
    of its tokens visible."""
    b = x_t.shape[0]
    q = P.dense_apply(p["q"], x_t).reshape(b, 1, -1, cfg.d_head)
    if sv is not None and sv.cache == "seq":
        lo, hi = sv.slots
        slot_pos = torch.arange(lo, hi, dtype=torch.int32, device=x_t.device)
        out = _split_kv_decode(q, cache["k"], cache["v"], slot_pos, cfg.n_img_tokens, cfg, sv,
                               None)
    else:
        kc, vc = _read_kv(cache["k"], cache["v"], sv, cfg)
        n = kc.shape[1]
        slot_pos = torch.arange(n, dtype=torch.int32, device=x_t.device)
        out = decode_attention(q, kc, vc, slot_pos, n, mma=cfg.mma_reductions)
    return _gated(p, _out(p, out.reshape(b, 1, -1), tp, sv))

"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3-4B).

Port of ``repro/models/mla.py`` (``mla_init``, ``_expand``, ``mla_train``,
``make_mla_cache``, ``mla_fill_cache``, ``mla_decode``). Q and KV are
projected through low-rank latents; the cache holds only the compressed
latent ``c_kv`` and the shared RoPE key (``kv_lora_rank + qk_rope_dim``
values a token), which is MLA's memory saving.

The routes are the reference's, which puts no kernel here:

  train / prefill  ``mla_train`` runs the chunked ``attention.flash_attention_
                   xla`` (qk 96 wide, v 64 wide, scale (nope + rope)**-0.5)
                   whatever ``cfg.use_kernels`` says, as the reference runs
                   it whatever ``use_pallas`` says; the two latent norms'
                   statistics go through ONE ``layers.rmsnorm_apply_many``
                   on the engine's route
  decode           ``mla_decode``, weight-absorbed: attention runs in the
                   latent space, the kv-latent norm over the whole cache
                   and the softmax denominator on ``backend_for_flags(mma)``

The absorbed decode's two f32 products (W_uk into the query, W_uv out of
the latent) run at full f32 (``layers.full_f32_matmul``: no TF32 on the
card); its score and PV products multiply bf16-rounded operands with f32
accumulation, as the reference's einsums with ``preferred_element_type``
do.

The latent cache is written IN PLACE at slot ``pos`` (the reference's is
an immutable array): as the KV cache's write (``models.attention``), it is
idempotent, so a decode step retried from its committed state rewrites
the same values and reproduces the clean step bitwise.

The operand rounding is ``attention.bf16_round`` (read at call time), the
attention's own. Sharded serving (``models.parallel``): the latent cache
cut by slots is filled with the rank's slots (``mla_fill_cache(slot0=)``)
and the decode is a split-KV decode in latent space (``mla_decode(sv=)``).
"""

from __future__ import annotations

import torch

from repro_torch import reduce as R
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import params as P


def cfg_dtype(cfg) -> torch.dtype:
    """The config's parameter and cache dtype (``models.model.param_dtype``)."""
    return getattr(torch, cfg.dtype)


def mla_init(gen, cfg, dtype, device) -> dict:
    """The five projections and the two latent RMSNorm scales, drawn from
    ``gen`` in the reference's order (q_down, q_up, kv_down, kv_up, o)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "q_down": P.dense_init(gen, d, m.q_lora_rank, dtype, device),
        "q_up": P.dense_init(gen, m.q_lora_rank, h * qk, dtype, device),
        "kv_down": P.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_dim, dtype, device),
        "kv_up": P.dense_init(gen, m.kv_lora_rank, h * (m.qk_nope_dim + m.v_head_dim), dtype,
                              device),
        "o": P.dense_init(gen, h * m.v_head_dim, d, dtype, device),
        "q_norm": P.norm_init("rmsnorm", m.q_lora_rank, dtype, device),
        "kv_norm": P.norm_init("rmsnorm", m.kv_lora_rank, dtype, device),
    }


def _expand(p, x, positions, cfg, tp=None):
    """x (B, S, d) -> per-head q (B, S, H, nope + rope), k (the same), v
    (B, S, H, v_head) with RoPE applied, and the raw kv latent (B, S,
    kv_lora + rope) before its norm. Both latent norms' statistics are one
    ``rmsnorm_apply_many`` pass. ``tp`` (``models.parallel.TP``): q_up and
    kv_up hold a rank's heads (H of them, read from q_up's columns, which
    are head-major; H may be 0), and the two normed latents and the shared
    RoPE key, which every rank's heads read, go through ``tp.enter``
    (Megatron's f)."""
    m = cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_dim + m.qk_rope_dim
    h = p["q_up"]["w"].shape[1] // qk
    cq = P.dense_apply(p["q_down"], x)
    ckv_full = P.dense_apply(p["kv_down"], x)
    ckv_raw, k_rope = ckv_full[..., :m.kv_lora_rank], ckv_full[..., m.kv_lora_rank:]
    cq, ckv = L.rmsnorm_apply_many((p["q_norm"], p["kv_norm"]), (cq, ckv_raw),
                                   eps=cfg.norm_eps, mma=cfg.mma_reductions)
    k_rope = L.rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # one shared head
    if tp is not None:
        cq, ckv, k_rope = tp.enter(cq), tp.enter(ckv), tp.enter(k_rope)
    q = P.dense_apply(p["q_up"], cq).reshape(b, s, h, qk)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = L.rope(q_rope, positions, cfg.rope_theta)
    kv = P.dense_apply(p["kv_up"], ckv).reshape(b, s, h, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    k_rope_b = k_rope.expand(b, s, h, m.qk_rope_dim)
    return torch.cat([q_nope, q_rope], -1), torch.cat([k_nope, k_rope_b], -1), v, ckv_full


def mla_train(p, x, positions, cfg, tp=None):
    """(B, S, d) -> (B, S, d): causal MLA, train/prefill path, on the
    chunked non-kernel attention (the reference's route). ``tp``: the
    rank's heads (``_expand``), o row-parallel and its partial sums
    through ``tp.exit`` (Megatron's g). A rank with no heads gives zeros
    to g, its empty q, k and v still in the graph, so that its f's
    all-reduces run in the backward as every other rank's do."""
    m = cfg.mla
    q, k, v, _ = _expand(p, x, positions, cfg, tp)
    b, s, h = q.shape[:3]
    if h:
        scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
        out = A.flash_attention_xla(q, k, v, causal=True, mma=cfg.mma_reductions, sm_scale=scale)
    else:
        out = torch.cat([q, k, v], -1)
    out = P.dense_apply(p["o"], out.reshape(b, s, h * m.v_head_dim))
    return out if tp is None else tp.exit(out)


def make_mla_cache(batch: int, s_max: int, cfg, dtype, device) -> dict:
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, s_max, m.kv_lora_rank + m.qk_rope_dim), dtype=dtype,
                           device=device),
        "slot_pos": torch.full((s_max,), -1, dtype=torch.int32, device=device),
    }


def _latent(p, x, positions, cfg) -> torch.Tensor:
    """What the cache stores for x: the raw kv latent, and the shared key
    with RoPE applied at write time (positions are absolute)."""
    m = cfg.mla
    ckv_full = P.dense_apply(p["kv_down"], x)
    k_rope = L.rope(ckv_full[..., m.kv_lora_rank:][:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0, :]
    return torch.cat([ckv_full[..., :m.kv_lora_rank], k_rope], -1)


def mla_fill_cache(p, x, positions, cache: dict, cfg, slot0: int = 0) -> dict:
    """Prefill: the prompt's latents into slots [0, S), in place.
    ``slot0``: a cache that holds the block of slots from ``slot0`` on (a
    rank's, the latent cut by slots) gets its slots of the prompt;
    ``slot_pos`` is whole on every rank and written whole."""
    s = x.shape[1]
    if s > cache["slot_pos"].shape[0]:
        raise ValueError(f"prompt of {s} tokens exceeds the cache length "
                         f"{cache['slot_pos'].shape[0]}")
    n = max(0, min(s - slot0, cache["ckv"].shape[1]))
    cache["ckv"][:, :n] = _latent(p, x, positions, cfg)[:, slot0:slot0 + n]
    cache["slot_pos"][:s] = torch.arange(s, dtype=torch.int32, device=x.device)
    return cache


def mla_decode(p, x_t, cache: dict, pos: int, cfg, tp=None, sv=None):
    """One weight-absorbed decode step at absolute position ``pos``. x_t:
    (B, 1, d). Writes this step's latent at slot ``pos`` (in place), then

      score_h(i) = (W_uk_h^T q_nope_h) . c_i + q_rope_h . k_rope_i
      out_h      = W_uv_h^T (sum_i p_h(i) c_i)

    over the normed latents c_i of every slot: no per-head K/V is expanded
    over the cache. Returns (out (B, 1, d), cache).

    ``tp`` (``models.parallel.TP``): q_up, kv_up and o hold a rank's heads,
    o's partial sums through ``tp.exit``. ``sv`` (``models.parallel.
    Serve``): the rank's heads and its block of the latent; only the rank
    whose block holds slot ``pos`` writes it (``slot_pos`` is whole and
    written on every rank). A latent cut by slots decodes split-KV: q_c
    and q_rope gathered over "model" where the heads are cut (blocks of
    unequal sizes, ``sv.q_sizes``, padded to the largest), every
    head's partial softmax over the rank's slots (the kv-latent norm of
    its own slots), the partials merged in rank order
    (``attention.merge_partials``), then the rank's heads through W_uv.
    The merge can only round the unnormalised weights to bf16 where one
    device rounds the normalised ones, so the two part by bf16's error."""
    m = cfg.mla
    b = x_t.shape[0]
    s_max = cache["slot_pos"].shape[0]
    if pos >= s_max:
        raise ValueError(f"decode position {pos} is past the cache length {s_max}")
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=x_t.device)
    cq = P.dense_apply(p["q_down"], x_t)
    cq = L.norm_apply("rmsnorm", p["q_norm"], cq, eps=cfg.norm_eps, mma=cfg.mma_reductions)
    qk = m.qk_nope_dim + m.qk_rope_dim
    h = p["q_up"]["w"].shape[1] // qk
    q = P.dense_apply(p["q_up"], cq).reshape(b, 1, h, qk)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = L.rope(q_rope, posb, cfg.rope_theta)[:, 0]                 # (B, H, dr)
    lo = 0 if sv is None else sv.slots[0]
    if lo <= pos < lo + cache["ckv"].shape[1]:
        cache["ckv"][:, pos - lo] = _latent(p, x_t, posb, cfg)[:, 0]
    cache["slot_pos"][pos] = pos
    wkv = p["kv_up"]["w"].reshape(m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim)
    w_uk, w_uv = wkv[..., :m.qk_nope_dim], wkv[..., m.qk_nope_dim:]
    with L.full_f32_matmul():
        q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(torch.float32),
                           w_uk.to(torch.float32))
    ckv = cache["ckv"]
    slot_pos = cache["slot_pos"][lo:lo + ckv.shape[1]]
    split = sv is not None and sv.cache == "seq"
    if split and sv.q_heads != (0, cfg.n_heads):
        # every head reads every slot
        q_c, q_rope = sv.gather(q_c, 1, sv.q_sizes), sv.gather(q_rope, 1, sv.q_sizes)
    c_all = L.norm_apply("rmsnorm", p["kv_norm"], ckv[..., :m.kv_lora_rank],
                         eps=cfg.norm_eps, mma=cfg.mma_reductions)      # (B, S, R)
    k_rope_all = ckv[..., m.kv_lora_rank:]                              # (B, S, dr)
    c_b = A.bf16_round(c_all)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    s = (torch.einsum("bhr,bsr->bhs", A.bf16_round(q_c), c_b)
         + torch.einsum("bhd,bsd->bhs", A.bf16_round(q_rope), A.bf16_round(k_rope_all))) * scale
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    s = torch.where(valid, s, A.NEG)
    mx = s.amax(-1, keepdim=True)
    e = torch.where(valid, torch.exp(s - mx), 0.0)
    denom = R.reduce(e, axis=-1, backend=R.backend_for_flags(cfg.mma_reductions))
    if split:
        o_lat = A.merge_partials(sv, mx, denom, torch.einsum("bhs,bsr->bhr", A.bf16_round(e), c_b))
        o_lat = o_lat[:, sv.q_heads[0]:sv.q_heads[1]]                  # (B, H', R)
    else:
        p_attn = e / torch.clamp_min(denom, 1e-30)[..., None]           # (B, H, S)
        o_lat = torch.einsum("bhs,bsr->bhr", A.bf16_round(p_attn), c_b)  # (B, H, R)
    with L.full_f32_matmul():
        out_h = torch.einsum("bhr,rhd->bhd", o_lat, w_uv.to(torch.float32))
    out = P.dense_apply(p["o"], out_h.reshape(b, 1, h * m.v_head_dim).to(x_t.dtype))
    return out if tp is None else tp.exit(out), cache

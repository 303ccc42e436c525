"""Model assembly: the decoder stack for training, prefill and decode.

Port of ``repro/models/model.py`` for two block kinds, chosen per layer
from ``cfg.pattern_layers``:

  attn  self-attention (``models.attention``; MLA, ``models.mla``, when
        ``cfg.mla`` is set) and a dense FFN (olmo-1b, internlm2-1.8b,
        deepseek-7b, minicpm3-4b) or an MoE FFN (granite-moe-1b-a400m,
        dbrx-132b; ``models.moe``); its cache is the KV cache, or MLA's
        compressed latent
  ssm   the Mamba-2 block (``models.ssm``; mamba2-780m), no FFN; its cache
        is O(1): the conv window and the SSD state

``block_init``, ``block_train``, ``block_make_cache``, ``block_fill_cache``
and ``block_decode`` dispatch on the kind, as the reference's do; the kinds
not ported yet (``rec``, ``local_attn``, ``xattn``) raise
``NotImplementedError`` naming the ROADMAP item they wait for. Heads are
tied or untied. The reference stacks unit parameters on a leading axis for
``lax.scan``; here each layer is its own entry of ``params["layers"]``
(caches: ``caches["layers"]``) and the stack is a Python loop.

  forward_hidden  (B, S) tokens -> (final normed hidden, aux), every layer
                  under ``torch.utils.checkpoint`` when ``cfg.remat`` (the
                  reference's ``jax.checkpoint`` of the scanned unit); aux
                  is the f32 sum over layers of the MoE's ``moe_aux`` and
                  ``moe_z`` (zero for a dense FFN)
  forward         (B, S) tokens -> (logits (B, S, vocab_size), aux): the
                  teacher-forcing contract
  prefill         (B, S) tokens -> last-token logits, caches filled
  decode_step     one token per slot against the caches -> (logits, a NEW
                  caches dict): the KV and latent caches are written in
                  place at the step's slot (idempotent under retry); the
                  SSM caches are replaced by new tensors, never written
                  (a retry from the committed caches must not see the
                  step applied once already)

Prefill and decode run the MoE FFN and drop its aux, as the reference does.

Both routes run here: ``cfg.use_kernels`` puts the norms and the
train/prefill attention on the CUDA kernels; without it they run the
reference's non-kernel route (``layers.norm_apply``'s engine row
statistics, ``attention.flash_attention_xla``), with ``cfg.mma_reductions``
choosing the ones-MMA or the plain reduce backend.

Logits are f32 (the head multiplies in f32, as the reference's einsum
does: by the embedding table when tied, by ``params["head"]["w"]``, (d,
padded vocab), when not), soft-capped when ``cfg.logits_softcap`` is set,
and pad-vocab masked. ``_head`` keeps the padded width (the chunked
loss uses it, as the reference's does); ``_head_public`` cuts it to
``vocab_size`` entries.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import params as P
from repro_torch.models import ssm as SSM

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def param_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# the block kinds of the reference not ported yet, and the ROADMAP item
# (Queue 1, "the other model families") that brings each
_WAITING = {
    "rec": "the RG-LRU family (recurrentgemma-9b)",
    "local_attn": "local attention with ring caches (the RG-LRU family, recurrentgemma-9b)",
    "xattn": "vision cross-attention (llama-3.2-vision-11b)",
}


def _check_kind(kind: str) -> None:
    if kind in ("attn", "ssm"):
        return
    if kind in _WAITING:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: it waits for {_WAITING[kind]}, in the "
            "ROADMAP's item on the other model families")
    raise ValueError(f"unknown block kind {kind!r}")


def _check_ported(cfg) -> None:
    for kind in cfg.pattern_layers:
        _check_kind(kind)


def _has_ffn(kind: str) -> bool:
    return kind in ("attn", "local_attn", "xattn", "rec")


def f32_param_count(cfg) -> int:
    """Parameters kept at f32 whatever ``cfg.dtype``: the MoE routers, and
    each SSM block's ``dt_bias``, ``A_log`` and ``D`` (one a head each)."""
    n = 0
    for kind in cfg.pattern_layers:
        if kind == "ssm":
            n += 3 * SSM._dims(cfg)[2]
        elif cfg.moe is not None and _has_ffn(kind):
            n += cfg.d_model * cfg.moe.n_experts
    return n


def stored_param_count(cfg) -> int:
    """Elements ``init_params`` stores: ``cfg.param_count()`` and what the
    reference's formula leaves out -- the padded vocabulary rows of the
    embedding and of an untied head, the RMSNorm scales (the blocks' and
    the final norm's, MLA's two latent norms), and per SSM block the one
    value a head that its approximate term (``d_in + 2 nh`` for ``d_in +
    3 nh``) misses."""
    pad_rows = (P.padded_vocab(cfg.vocab_size) - cfg.vocab_size) * (2 - cfg.tie_embeddings)
    n = cfg.param_count() + pad_rows * cfg.d_model
    rms = cfg.norm == "rmsnorm"
    for kind in cfg.pattern_layers:
        if kind == "ssm":
            n += rms * cfg.d_model + SSM._dims(cfg)[2]
            continue
        n += rms * 2 * cfg.d_model
        if cfg.mla is not None:
            n += cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank
    return n + rms * cfg.d_model


def _ffn_init(gen, cfg, device) -> dict:
    dt = param_dtype(cfg)
    if cfg.moe is not None:
        return MOE.moe_init(gen, cfg, dt, device)
    return L.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, dt, device)


def _ffn_apply(p, h, cfg):
    """The block's FFN -> (y, metrics); a dense FFN has no metrics."""
    if cfg.moe is not None:
        return MOE.moe_apply(p, h, cfg)
    return L.ffn_apply(p, h), {}


def _aux(metrics: dict, device) -> torch.Tensor:
    """A block's aux loss: the sum of its ``moe_aux`` and ``moe_z``."""
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for k in ("moe_aux", "moe_z"):
        if k in metrics:
            aux = aux + metrics[k]
    return aux


def block_init(kind: str, gen, cfg, device) -> dict:
    """One block's parameters, drawn from ``gen``: norm1, the mixer and,
    for a kind with an FFN, norm2 and the FFN."""
    _check_kind(kind)
    dt = param_dtype(cfg)
    d = cfg.d_model
    p = {"norm1": P.norm_init(cfg.norm, d, dt, device)}
    if kind == "ssm":
        p["mix"] = SSM.ssm_init(gen, cfg, dt, device)
    elif cfg.mla is not None:
        p["mix"] = MLA.mla_init(gen, cfg, dt, device)
    else:
        p["mix"] = A.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, dt, device)
    if _has_ffn(kind):
        p["norm2"] = P.norm_init(cfg.norm, d, dt, device)
        p["ffn"] = _ffn_init(gen, cfg, device)
    return p


def init_params(cfg, gen: torch.Generator, device) -> dict:
    """Random parameters drawn from ``gen`` (a generator on ``device``), in
    order: the embedding, the layers, then an untied head's (d, padded
    vocab) weight."""
    _check_ported(cfg)
    dt = param_dtype(cfg)
    params = {
        "embed": P.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "layers": [block_init(kind, gen, cfg, device) for kind in cfg.pattern_layers],
        "final_norm": P.norm_init(cfg.norm, cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = P.dense_init(gen, cfg.d_model, P.padded_vocab(cfg.vocab_size), dt,
                                      device)
    return params


def _norm(p, h, cfg):
    return L.norm_apply(cfg.norm, p, h, eps=cfg.norm_eps, mma=cfg.mma_reductions,
                        use_kernels=cfg.use_kernels)


def _embed(params, tokens):
    return params["embed"]["table"][tokens]


def _mask_pad_logits(logits, cfg):
    """Pad-vocab logits are masked to -1e30 so argmax and softmax see the
    unpadded math."""
    nv = logits.shape[-1]
    if nv == cfg.vocab_size:
        return logits
    pad = torch.arange(nv, device=logits.device) >= cfg.vocab_size
    return torch.where(pad, -1e30, logits)


def _head(params, cfg, h):
    """The head in f32 -> (B, S, padded vocab): the embedding table when
    tied, ``head.w`` when not; the soft cap, then pad logits at -1e30."""
    if cfg.tie_embeddings:
        w = params["embed"]["table"].to(torch.float32).T
    else:
        w = params["head"]["w"].to(torch.float32)
    logits = torch.matmul(h.to(torch.float32), w)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return _mask_pad_logits(logits, cfg)


def _head_public(params, cfg, h):
    """Public logits contract: exactly ``vocab_size`` entries."""
    return _head(params, cfg, h)[..., : cfg.vocab_size]


def _ffn_residual(kind, p, h, cfg):
    """h plus the block's FFN of norm2(h) (a kind with an FFN) -> (h, aux)."""
    if not _has_ffn(kind):
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    y, metrics = _ffn_apply(p["ffn"], _norm(p["norm2"], h, cfg), cfg)
    return h + y, _aux(metrics, h.device)


def block_train(kind: str, p, h, positions, cfg):
    """One block, train/prefill compute: (B, S, d) -> ((B, S, d), aux f32
    scalar)."""
    hn = _norm(p["norm1"], h, cfg)
    if kind == "ssm":
        mix = SSM.ssm_train(p["mix"], hn, cfg)
    elif cfg.mla is not None:
        mix = MLA.mla_train(p["mix"], hn, positions, cfg)
    else:
        mix = A.self_attention_train(p["mix"], hn, positions, cfg)
    return _ffn_residual(kind, p, h + mix, cfg)


def block_make_cache(kind: str, batch: int, s_max: int, cfg, device) -> dict:
    dt = param_dtype(cfg)
    if kind == "ssm":
        return SSM.make_ssm_cache(batch, cfg, dt, device)
    if cfg.mla is not None:
        return MLA.make_mla_cache(batch, s_max, cfg, dt, device)
    return A.make_kv_cache(batch, s_max, cfg.n_kv_heads, cfg.d_head, dt, device)


def block_fill_cache(kind: str, p, h, positions, cache, cfg):
    """Prefill: run the block AND fill its cache from norm1(h), the stream
    the mixer reads. -> (h, cache): the KV and latent caches are filled in
    place; the SSM block returns its cache from the train path's scan (the
    conv window and the final state: the exact prefill -> decode
    handoff)."""
    hn = _norm(p["norm1"], h, cfg)
    if kind == "ssm":
        mix, cache = SSM.ssm_train(p["mix"], hn, cfg, return_state=True)
    elif cfg.mla is not None:
        cache = MLA.mla_fill_cache(p["mix"], hn, positions, cache, cfg)
        mix = MLA.mla_train(p["mix"], hn, positions, cfg)
    else:
        mix, k, v = A.self_attention_train(p["mix"], hn, positions, cfg, return_kv=True)
        A.fill_kv_cache(cache, k, v)
    return _ffn_residual(kind, p, h + mix, cfg)[0], cache


def block_decode(kind: str, p, h, cache, pos: int, cfg):
    """One decode step of one block -> (h, cache) (see the module doc for
    which caches are written in place and which are new)."""
    hn = _norm(p["norm1"], h, cfg)
    if kind == "ssm":
        mix, cache = SSM.ssm_decode(p["mix"], hn, cache, cfg)
    elif cfg.mla is not None:
        mix, cache = MLA.mla_decode(p["mix"], hn, cache, pos, cfg)
    else:
        mix, cache = A.self_attention_decode(p["mix"], hn, cache, pos, cfg)
    return _ffn_residual(kind, p, h + mix, cfg)[0], cache


def forward_hidden(params, cfg, tokens: torch.Tensor):
    """Backbone forward to the final normed hidden state (B, S, d) and the
    aux loss summed over layers; no head (the chunked loss applies it per
    sequence chunk). -> (h, aux)."""
    _check_ported(cfg)
    h = _embed(params, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for kind, p in zip(cfg.pattern_layers, params["layers"]):
        if cfg.remat:
            h, a = checkpoint(block_train, kind, p, h, positions, cfg, use_reentrant=False)
        else:
            h, a = block_train(kind, p, h, positions, cfg)
        aux = aux + a
    return _norm(params["final_norm"], h, cfg), aux


def forward(params, cfg, tokens: torch.Tensor):
    """Teacher-forcing forward. tokens: (B, S) -> (logits (B, S,
    vocab_size) f32, aux f32 scalar)."""
    h, aux = forward_hidden(params, cfg, tokens)
    return _head_public(params, cfg, h), aux


def make_caches(cfg, batch: int, s_max: int, device) -> dict:
    _check_ported(cfg)
    return {"layers": [block_make_cache(kind, batch, s_max, cfg, device)
                       for kind in cfg.pattern_layers]}


def prefill(params, cfg, tokens: torch.Tensor, caches: dict):
    """Run the prompt, filling caches. Returns (last-token logits (B, 1, V),
    caches)."""
    _check_ported(cfg)
    h = _embed(params, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    filled = []
    for kind, p, cache in zip(cfg.pattern_layers, params["layers"], caches["layers"]):
        h, cache = block_fill_cache(kind, p, h, positions, cache, cfg)
        filled.append(cache)
    h = _norm(params["final_norm"], h, cfg)
    return _head_public(params, cfg, h[:, -1:]), {"layers": filled}


def decode_step(params, cfg, token_t: torch.Tensor, caches: dict, pos: int):
    """One token step. token_t: (B, 1); pos: the absolute position of this
    token. Returns (logits (B, 1, V), a new caches dict); the dict given is
    not changed, and its SSM caches' tensors are not written (see the
    module doc)."""
    _check_ported(cfg)
    h = _embed(params, token_t)
    stepped = []
    for kind, p, cache in zip(cfg.pattern_layers, params["layers"], caches["layers"]):
        h, cache = block_decode(kind, p, h, cache, pos, cfg)
        stepped.append(cache)
    h = _norm(params["final_norm"], h, cfg)
    return _head_public(params, cfg, h), {"layers": stepped}

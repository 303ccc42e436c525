"""Model assembly: the decoder stack for training, prefill and decode.

Port of ``repro/models/model.py`` restricted to the ``attn`` block with a
dense FFN (olmo-1b, internlm2-1.8b, deepseek-7b) or an MoE FFN
(granite-moe-1b-a400m, dbrx-132b; ``models.moe``), with tied or untied
heads. The reference stacks unit parameters on a leading axis for
``lax.scan``; here each layer is its own entry of ``params["layers"]`` and
the stack is a Python loop.

  forward_hidden  (B, S) tokens -> (final normed hidden, aux), every layer
                  under ``torch.utils.checkpoint`` when ``cfg.remat`` (the
                  reference's ``jax.checkpoint`` of the scanned unit); aux
                  is the f32 sum over layers of the MoE's ``moe_aux`` and
                  ``moe_z`` (zero for a dense FFN)
  forward         (B, S) tokens -> (logits (B, S, vocab_size), aux): the
                  teacher-forcing contract
  prefill         (B, S) tokens -> last-token logits, caches filled
  decode_step     one token per slot against the caches (written in place)

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
from repro_torch.models import moe as MOE
from repro_torch.models import params as P

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def param_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def f32_param_count(cfg) -> int:
    """Parameters kept at f32 whatever ``cfg.dtype``: the MoE routers."""
    return cfg.n_layers * cfg.d_model * cfg.moe.n_experts if cfg.moe is not None else 0


def _check_ported(cfg) -> None:
    """``attn`` blocks with a dense or an MoE FFN are ported."""
    for kind in cfg.pattern_layers:
        if kind != "attn":
            raise NotImplementedError(f"block kind {kind!r} is not ported; only 'attn' is")


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


def block_init(gen, cfg, device) -> dict:
    dt = param_dtype(cfg)
    d = cfg.d_model
    return {
        "norm1": P.norm_init(cfg.norm, d, dt, device),
        "mix": A.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, dt, device),
        "norm2": P.norm_init(cfg.norm, d, dt, device),
        "ffn": _ffn_init(gen, cfg, device),
    }


def init_params(cfg, gen: torch.Generator, device) -> dict:
    """Random parameters drawn from ``gen`` (a generator on ``device``), in
    order: the embedding, the layers, then an untied head's (d, padded
    vocab) weight."""
    _check_ported(cfg)
    dt = param_dtype(cfg)
    params = {
        "embed": P.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "layers": [block_init(gen, cfg, device) for _ in range(cfg.n_layers)],
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


def block_train(p, h, positions, cfg):
    """One ``attn`` block, train/prefill compute: (B, S, d) -> ((B, S, d),
    aux f32 scalar)."""
    h = h + A.self_attention_train(p["mix"], _norm(p["norm1"], h, cfg), positions, cfg)
    y, metrics = _ffn_apply(p["ffn"], _norm(p["norm2"], h, cfg), cfg)
    return h + y, _aux(metrics, h.device)


def forward_hidden(params, cfg, tokens: torch.Tensor):
    """Backbone forward to the final normed hidden state (B, S, d) and the
    aux loss summed over layers; no head (the chunked loss applies it per
    sequence chunk). -> (h, aux)."""
    _check_ported(cfg)
    h = _embed(params, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p in params["layers"]:
        if cfg.remat:
            h, a = checkpoint(block_train, p, h, positions, cfg, use_reentrant=False)
        else:
            h, a = block_train(p, h, positions, cfg)
        aux = aux + a
    return _norm(params["final_norm"], h, cfg), aux


def forward(params, cfg, tokens: torch.Tensor):
    """Teacher-forcing forward. tokens: (B, S) -> (logits (B, S,
    vocab_size) f32, aux f32 scalar)."""
    h, aux = forward_hidden(params, cfg, tokens)
    return _head_public(params, cfg, h), aux


def make_caches(cfg, batch: int, s_max: int, device) -> dict:
    dt = param_dtype(cfg)
    return {
        "layers": [
            A.make_kv_cache(batch, s_max, cfg.n_kv_heads, cfg.d_head, dt, device)
            for _ in range(cfg.n_layers)
        ]
    }


def prefill(params, cfg, tokens: torch.Tensor, caches: dict):
    """Run the prompt, filling caches. Returns (last-token logits (B, 1, V),
    caches)."""
    _check_ported(cfg)
    h = _embed(params, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for p, cache in zip(params["layers"], caches["layers"]):
        mix, k, v = A.self_attention_train(
            p["mix"], _norm(p["norm1"], h, cfg), positions, cfg, return_kv=True
        )
        A.fill_kv_cache(cache, k, v)
        h = h + mix
        h = h + _ffn_apply(p["ffn"], _norm(p["norm2"], h, cfg), cfg)[0]
    h = _norm(params["final_norm"], h, cfg)
    return _head_public(params, cfg, h[:, -1:]), caches


def decode_step(params, cfg, token_t: torch.Tensor, caches: dict, pos: int):
    """One token step. token_t: (B, 1); pos: the absolute position of this
    token. Returns (logits (B, 1, V), caches)."""
    _check_ported(cfg)
    h = _embed(params, token_t)
    for p, cache in zip(params["layers"], caches["layers"]):
        mix, _ = A.self_attention_decode(p["mix"], _norm(p["norm1"], h, cfg), cache, pos, cfg)
        h = h + mix
        h = h + _ffn_apply(p["ffn"], _norm(p["norm2"], h, cfg), cfg)[0]
    h = _norm(params["final_norm"], h, cfg)
    return _head_public(params, cfg, h), caches

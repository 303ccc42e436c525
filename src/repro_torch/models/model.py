"""Model assembly: the decoder stack for training, prefill and decode.

Port of ``repro/models/model.py`` for every block kind, chosen per layer
from ``cfg.pattern_layers``:

  attn        self-attention (``models.attention``; MLA, ``models.mla``,
              when ``cfg.mla`` is set) and a dense FFN (olmo-1b,
              internlm2-1.8b, deepseek-7b, minicpm3-4b, llama-3.2-vision-
              11b) or an MoE FFN (granite-moe-1b-a400m, dbrx-132b;
              ``models.moe``); its cache is the KV cache, or MLA's
              compressed latent
  local_attn  self-attention within ``cfg.window`` and an FFN
              (recurrentgemma-9b); its cache a ring of min(s_max, window)
              slots
  xattn       gated cross-attention to the frontend's context ``ctx`` and
              an FFN (llama-3.2-vision-11b); its cache the context's keys
              and values, filled by the prefill, read by the decode
  ssm         the Mamba-2 block (``models.ssm``; mamba2-780m), no FFN; its
              cache is O(1): the conv window and the SSD state
  rec         the RG-LRU block (``models.rglru``; recurrentgemma-9b) and an
              FFN; its cache O(1): the conv window and the f32 state

``block_init``, ``block_train``, ``block_make_cache``, ``block_fill_cache``
and ``block_decode`` dispatch on the kind, as the reference's do. Heads are
tied or untied. The reference stacks unit parameters on a leading axis for
``lax.scan``; here each layer is its own entry of ``params["layers"]``
(caches: ``caches["layers"]``) and the stack is a Python loop.

The entry points take the frontend's context, ``ctx`` (B, N, d) or None,
which the cross-attention layers read (the reference threads it the same
way).

  forward_hidden  (B, S) tokens -> (final normed hidden, aux), every layer
                  under ``torch.utils.checkpoint`` when ``cfg.remat`` (the
                  reference's ``jax.checkpoint`` of the scanned unit); aux
                  is the f32 sum over layers of the MoE's ``moe_aux`` and
                  ``moe_z`` (zero for a dense FFN)
  forward         (B, S) tokens -> (logits (B, S, vocab_size), aux): the
                  teacher-forcing contract
  prefill         (B, S) tokens -> last-token logits, caches filled
  decode_step     one token per slot against the caches -> (logits, a NEW
                  caches dict): the KV, ring and latent caches are written
                  in place at the step's slot (idempotent under retry), the
                  cross-attention caches only read; the SSM and RG-LRU
                  caches are replaced by new tensors, never written (a
                  retry from the committed caches must not see the step
                  applied once already)

Prefill and decode run the MoE FFN and drop its aux, as the reference does.

An audio arch (``cfg.n_codebooks`` = K > 0, musicgen-medium) reads (B, S,
K) tokens: its embedding is a (K, vocab, d) table, not vocabulary-padded,
whose K gathered rows are summed in order k = 0 .. K-1, and its untied head
is (K, d, padded vocab), one head a stream, so its logits are (B, S, K,
vocab).

Both routes run here: ``cfg.use_kernels`` puts the norms and the
train/prefill attention on the CUDA kernels; without it they run the
reference's non-kernel route (``layers.norm_apply``'s engine row
statistics, ``attention.flash_attention_xla``), with ``cfg.mma_reductions``
choosing the ones-MMA or the plain reduce backend.

Logits are f32 (the head multiplies in f32, as the reference's einsum
does: by the embedding table when tied, by ``params["head"]["w"]``, (d,
padded vocab) or (K, d, padded vocab), when not), soft-capped when
``cfg.logits_softcap`` is set, and pad-vocab masked. ``_head`` keeps the
padded width (the chunked loss uses it, as the reference's does);
``_head_public`` cuts it to ``vocab_size`` entries.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import context as CTX
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import params as P
from repro_torch.models import rglru as REC
from repro_torch.models import ssm as SSM

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def param_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


KINDS = ("attn", "local_attn", "xattn", "ssm", "rec")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def _has_ffn(kind: str) -> bool:
    return kind in ("attn", "local_attn", "xattn", "rec")


def f32_param_count(cfg) -> int:
    """Parameters kept at f32 whatever ``cfg.dtype``: the MoE routers, each
    SSM block's ``dt_bias``, ``A_log`` and ``D`` (one a head each) and
    each RG-LRU block's ``lam`` (one a channel)."""
    n = 0
    for kind in cfg.pattern_layers:
        if kind == "ssm":
            n += 3 * SSM._dims(cfg)[2]
            continue
        if kind == "rec":
            n += REC._width(cfg)
        if cfg.moe is not None and _has_ffn(kind):
            n += cfg.d_model * cfg.moe.n_experts
    return n


def stored_param_count(cfg) -> int:
    """Elements ``init_params`` stores: ``cfg.param_count()`` and what the
    reference's formula leaves out -- the padded vocabulary rows of the
    embedding and of an untied head (with codebooks only the K heads' are
    padded, the (K, vocab, d) table is not), the norms' tensors (an
    RMSNorm's scale, a LayerNorm's scale and bias: the blocks' and the
    final norm's; MLA's two latent RMSNorms), per SSM block the one
    value a head that its approximate term (``d_in + 2 nh`` for ``d_in +
    3 nh``) misses, per RG-LRU block the difference between its ``3 w``
    and the ``2 w^2 / 16 + w`` values that ``gate_a``, ``gate_x`` and
    ``lam`` hold, and per cross-attention block its gate."""
    pad = P.padded_vocab(cfg.vocab_size) - cfg.vocab_size
    if cfg.n_codebooks:
        pad_rows = pad * cfg.n_codebooks * (not cfg.tie_embeddings)
    else:
        pad_rows = pad * (2 - cfg.tie_embeddings)
    n = cfg.param_count() + pad_rows * cfg.d_model
    norm = P.NORM_TENSORS[cfg.norm] * cfg.d_model
    for kind in cfg.pattern_layers:
        if kind == "ssm":
            n += norm + SSM._dims(cfg)[2]
            continue
        n += 2 * norm
        if kind == "rec":
            w = REC._width(cfg)
            n += 2 * w * w // REC.N_GATE_BLOCKS - 2 * w
        elif kind == "xattn":
            n += 1
        elif cfg.mla is not None:
            n += cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank
    return n + norm


def _ffn_init(gen, cfg, device) -> dict:
    dt = param_dtype(cfg)
    if cfg.moe is not None:
        return MOE.moe_init(gen, cfg, dt, device)
    return L.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, dt, device)


def _ffn_apply(p, h, cfg, hooks=None):
    """The block's FFN -> (y, metrics); a dense FFN has no metrics.
    ``hooks`` (``models.parallel.Hooks``): its tensor or expert
    parallelism."""
    if cfg.moe is not None:
        return MOE.moe_apply(p, h, cfg, ep=None if hooks is None else hooks.ep)
    return L.ffn_apply(p, h, cfg.ffn_kind, tp=None if hooks is None else hooks.ffn), {}


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
    elif kind == "rec":
        p["mix"] = REC.rglru_init(gen, cfg, dt, device)
    elif kind == "xattn":
        p["mix"] = A.cross_attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                          dt, device)
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
    vocab) weight. With K codebook streams the embedding is a (K, vocab,
    d) table and the head (K, d, padded vocab), both drawn at d**-0.5, as
    the reference draws them."""
    dt = param_dtype(cfg)
    d, nv = cfg.d_model, P.padded_vocab(cfg.vocab_size)
    k = cfg.n_codebooks
    embed = ({"table": P._normal(gen, (k, cfg.vocab_size, d), d**-0.5, dt, device)} if k
             else P.embed_init(gen, cfg.vocab_size, d, dt, device))
    params = {
        "embed": embed,
        "layers": [block_init(kind, gen, cfg, device) for kind in cfg.pattern_layers],
        "final_norm": P.norm_init(cfg.norm, d, dt, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = ({"w": P._normal(gen, (k, d, nv), d**-0.5, dt, device)} if k
                          else P.dense_init(gen, d, nv, dt, device))
    return params


# ------------------------------ logical axes ---------------------------------
# The reference's ``init_params`` returns an axes tree beside the parameters
# (``repro.models.params``' vocabulary: "vocab", "embed", "ffn", "heads",
# "kv_heads", "experts", "inner", None); ``launch.sharding`` maps it onto
# mesh axes. Here it is its own function of the config, leaf for leaf the
# port's parameter tree; a per-layer leaf has the reference's stacked axes
# without their leading (unsharded) layer axis.

def _dense_axes(a, b) -> dict:
    return {"w": (a, b)}


def _norm_axes(kind: str) -> dict:
    return {"scale": ("embed",), "bias": ("embed",)} if kind == "layernorm" else (
        {"scale": ("embed",)} if kind == "rmsnorm" else {})


def _mixer_axes(kind: str, cfg) -> dict:
    if kind == "ssm":
        return {"z": _dense_axes("embed", "inner"), "xbc": _dense_axes("embed", "inner"),
                "dt": _dense_axes("embed", None), "out": _dense_axes("inner", "embed"),
                "conv_w": (None, "inner"), "dt_bias": None, "A_log": None, "D": None,
                "norm_scale": ("inner",)}
    if kind == "rec":
        return {"in_x": _dense_axes("embed", "inner"), "in_gate": _dense_axes("embed", "inner"),
                "out": _dense_axes("inner", "embed"), "conv_w": (None, "inner"),
                "gate_a": ("inner", None, None), "gate_x": ("inner", None, None),
                "lam": ("inner",)}
    if kind != "xattn" and cfg.mla is not None:
        return {"q_down": _dense_axes("embed", None), "q_up": _dense_axes(None, "heads"),
                "kv_down": _dense_axes("embed", None), "kv_up": _dense_axes(None, "heads"),
                "o": _dense_axes("heads", "embed"), "q_norm": _norm_axes("rmsnorm"),
                "kv_norm": _norm_axes("rmsnorm")}
    axes = {"q": _dense_axes("embed", "heads"), "k": _dense_axes("embed", "kv_heads"),
            "v": _dense_axes("embed", "kv_heads"), "o": _dense_axes("heads", "embed")}
    if kind == "xattn":
        axes["gate"] = None
    return axes


def _ffn_axes(cfg) -> dict:
    if cfg.moe is not None:
        axes = {"router": ("embed", None), "up": ("experts", "embed", "ffn"),
                "down": ("experts", "ffn", "embed")}
        if cfg.ffn_kind == "swiglu":
            axes["gate"] = ("experts", "embed", "ffn")
        return axes
    axes = {"up": _dense_axes("embed", "ffn"), "down": _dense_axes("ffn", "embed")}
    if cfg.ffn_kind == "swiglu":
        axes["gate"] = _dense_axes("embed", "ffn")
    return axes


def block_axes(kind: str, cfg) -> dict:
    """One block's axes tree, the structure of ``block_init``'s."""
    _check_kind(kind)
    axes = {"norm1": _norm_axes(cfg.norm), "mix": _mixer_axes(kind, cfg)}
    if _has_ffn(kind):
        axes["norm2"] = _norm_axes(cfg.norm)
        axes["ffn"] = _ffn_axes(cfg)
    return axes


def param_axes(cfg) -> dict:
    """The logical-axes tree of ``init_params(cfg, ...)``: one tuple of
    names a leaf (one name or None a dim), or None for a leaf the rules
    never cut. Checked against the shapes of ``init_params`` on the meta
    device (no allocation): every leaf's tuple has its rank."""
    books = cfg.n_codebooks
    axes = {
        "embed": {"table": (None, "vocab", "embed") if books else ("vocab", None)},
        "layers": [block_axes(kind, cfg) for kind in cfg.pattern_layers],
        "final_norm": _norm_axes(cfg.norm),
    }
    if not cfg.tie_embeddings:
        axes["head"] = {"w": (None, None, "vocab") if books else (None, "vocab")}
    shapes = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    _check_axes(axes, shapes)
    return axes


def _check_axes(axes, shapes, path=()) -> None:
    if isinstance(shapes, torch.Tensor):
        if axes is not None and len(axes) != shapes.ndim:
            raise AssertionError(f"axes {axes} at {path} for a leaf of shape "
                                 f"{tuple(shapes.shape)}")
        return
    keys = range(len(shapes)) if isinstance(shapes, list) else shapes.keys()
    if (len(axes) != len(shapes) or (isinstance(shapes, dict)
                                     and set(axes) != set(shapes))):
        raise AssertionError(f"the axes tree at {path} does not match the parameters")
    for k in keys:
        _check_axes(axes[k], shapes[k], path + (k,))


def _norm(p, h, cfg):
    return L.norm_apply(cfg.norm, p, h, eps=cfg.norm_eps, mma=cfg.mma_reductions,
                        use_kernels=cfg.use_kernels)


def _embed(params, cfg, tokens, plan=None):
    """(B, S) tokens -> their embedding rows; (B, S, K) codebook tokens ->
    the sum of the K streams' rows, added in order k = 0 .. K-1 in the
    parameters' dtype, as the reference adds them. Under a ``plan``
    (``models.parallel.Plan``) whose vocabulary is cut over "model", the
    vocab-parallel lookup (``Plan.embed``)."""
    table = params["embed"]["table"]
    if plan is not None:
        return plan.embed(table, tokens)
    if not cfg.n_codebooks:
        return table[tokens]
    h = table[0][tokens[..., 0]]
    for k in range(1, cfg.n_codebooks):
        h = h + table[k][tokens[..., k]]
    return h


def _mask_pad_logits(logits, cfg, col0: int = 0):
    """Pad-vocab logits are masked to -1e30 so argmax and softmax see the
    unpadded math. ``col0``: the global id of the first column (a
    vocab-parallel rank's logits are a slice of the vocabulary)."""
    nv = logits.shape[-1]
    if col0 + nv <= cfg.vocab_size:
        return logits
    pad = torch.arange(col0, col0 + nv, device=logits.device) >= cfg.vocab_size
    return torch.where(pad, -1e30, logits)


def _head(params, cfg, h, plan=None):
    """The head in f32 -> (B, S, padded vocab): the embedding table when
    tied, ``head.w`` when not (with K codebook streams (B, S, K, padded
    vocab), one head a stream); the soft cap, then pad logits at -1e30.
    Under a ``plan`` whose vocabulary is cut over "model", the rank's
    columns (from ``plan.vocab0``), masked by global column id."""
    col0 = 0
    if plan is not None:
        h, col0 = plan.head_input(h), plan.vocab0
    hf = h.to(torch.float32)
    if cfg.tie_embeddings:
        logits = torch.matmul(hf, params["embed"]["table"].to(torch.float32).T)
    elif cfg.n_codebooks:
        logits = torch.einsum("bsd,kdv->bskv", hf, params["head"]["w"].to(torch.float32))
    else:
        logits = torch.matmul(hf, params["head"]["w"].to(torch.float32))
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return _mask_pad_logits(logits, cfg, col0)


def _head_public(params, cfg, h):
    """Public logits contract: exactly ``vocab_size`` entries."""
    return _head(params, cfg, h)[..., : cfg.vocab_size]


def _ffn_residual(kind, p, h, cfg, hooks=None):
    """h plus the block's FFN of norm2(h) (a kind with an FFN) -> (h, aux)."""
    if not _has_ffn(kind):
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    y, metrics = _ffn_apply(p["ffn"], _norm(p["norm2"], h, cfg), cfg, hooks)
    return h + y, _aux(metrics, h.device)


def _final_norm(params, cfg, h, plan=None):
    """The final norm; under a ``plan`` its scale FSDP-gathered (the head's
    weights are never cut over the batch axes)."""
    final = params["final_norm"]
    if plan is not None:
        final = plan.gather(final, plan.specs["final_norm"])
    return _norm(final, h, cfg)


def _serve_logits(params, cfg, h, plan):
    """The serving head of the last hidden states: ``vocab_size`` logits,
    or under a ``plan`` the rank's columns of the padded vocabulary, pads
    masked (``Plan.gather_logits`` and ``Plan.greedy`` take them whole)."""
    h = _final_norm(params, cfg, h, plan)
    return _head_public(params, cfg, h) if plan is None else _head(params, cfg, h, plan)


def _window(kind: str, cfg):
    return cfg.window if kind == "local_attn" else None


def block_train(kind: str, p, h, positions, cfg, ctx=None, hooks=None):
    """One block, train/prefill compute: (B, S, d) -> ((B, S, d), aux f32
    scalar). ``ctx`` is the cross-attention layers' context; ``hooks``
    (``models.parallel.Hooks``) the block's tensor and expert parallelism
    (``hooks.attn`` the mixer's: attention, MLA, cross-attention, the SSM
    or the RG-LRU), its weights a rank's (``Plan.block``)."""
    hn = _norm(p["norm1"], h, cfg)
    tp = None if hooks is None else hooks.attn
    if kind == "ssm":
        mix = SSM.ssm_train(p["mix"], hn, cfg, tp=tp)
    elif kind == "rec":
        mix = REC.rglru_train(p["mix"], hn, cfg, tp=tp)
    elif kind == "xattn":
        mix = A.cross_attention_apply(p["mix"], hn, ctx, cfg, tp=tp)
    elif cfg.mla is not None:
        mix = MLA.mla_train(p["mix"], hn, positions, cfg, tp=tp)
    else:
        mix = A.self_attention_train(p["mix"], hn, positions, cfg, window=_window(kind, cfg),
                                     tp=tp)
    return _ffn_residual(kind, p, h + mix, cfg, hooks)


def block_make_cache(kind: str, batch: int, s_max: int, cfg, device) -> dict:
    _check_kind(kind)
    dt = param_dtype(cfg)
    if kind == "ssm":
        return SSM.make_ssm_cache(batch, cfg, dt, device)
    if kind == "rec":
        return REC.make_rglru_cache(batch, cfg, dt, device)
    if kind == "xattn":
        shape = (batch, cfg.n_img_tokens, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.mla is not None:
        return MLA.make_mla_cache(batch, s_max, cfg, dt, device)
    if kind == "local_attn" and cfg.window:
        s_max = min(s_max, cfg.window)  # the ring
    return A.make_kv_cache(batch, s_max, cfg.n_kv_heads, cfg.d_head, dt, device)


def block_fill_cache(kind: str, p, h, positions, cache, cfg, ctx=None, hooks=None):
    """Prefill: run the block AND fill its cache from norm1(h), the stream
    the mixer reads. -> (h, cache): the KV (ring) and latent caches are
    filled in place, a cross-attention layer's with the keys and values of
    the context as given (not normed); the SSM and RG-LRU blocks return
    their caches from the train path's scan (the conv window and the final
    state: the exact prefill -> decode handoff). ``hooks``: the sharded
    prefill's (``Plan.serve_block``): the mixer's tensor parallelism, and
    the rank's heads or channels and its block of the cache."""
    hn = _norm(p["norm1"], h, cfg)
    tp, sv = (None, None) if hooks is None else (hooks.attn, hooks.serve)
    slot0 = 0 if sv is None or sv.slots is None else sv.slots[0]
    if kind == "ssm":
        mix, cache = SSM.ssm_train(p["mix"], hn, cfg, return_state=True, tp=tp, sv=sv)
    elif kind == "rec":
        mix, cache = REC.rglru_train(p["mix"], hn, cfg, return_state=True, tp=tp, sv=sv)
    elif kind == "xattn":
        A.fill_cross_cache(cache, *A.cross_kv(p["mix"], ctx, cfg), sv)
        mix = A.cross_attention_apply(p["mix"], hn, ctx, cfg, tp=tp, sv=sv)
    elif cfg.mla is not None:
        cache = MLA.mla_fill_cache(p["mix"], hn, positions, cache, cfg, slot0)
        mix = MLA.mla_train(p["mix"], hn, positions, cfg, tp=tp)
    else:
        mix, k, v = A.self_attention_train(p["mix"], hn, positions, cfg,
                                           window=_window(kind, cfg), return_kv=True, tp=tp,
                                           sv=sv)
        A.fill_kv_cache(cache, k, v, slot0)
    return _ffn_residual(kind, p, h + mix, cfg, hooks)[0], cache


def block_decode(kind: str, p, h, cache, pos: int, cfg, hooks=None):
    """One decode step of one block -> (h, cache) (see the module doc for
    which caches are written in place and which are new); ``hooks`` as in
    ``block_fill_cache``."""
    hn = _norm(p["norm1"], h, cfg)
    tp, sv = (None, None) if hooks is None else (hooks.attn, hooks.serve)
    if kind == "ssm":
        mix, cache = SSM.ssm_decode(p["mix"], hn, cache, cfg, tp=tp, sv=sv)
    elif kind == "rec":
        mix, cache = REC.rglru_decode(p["mix"], hn, cache, cfg, tp=tp, sv=sv)
    elif kind == "xattn":
        mix = A.cross_attention_decode(p["mix"], hn, cache, cfg, tp=tp, sv=sv)
    elif cfg.mla is not None:
        mix, cache = MLA.mla_decode(p["mix"], hn, cache, pos, cfg, tp=tp, sv=sv)
    else:
        mix, cache = A.self_attention_decode(p["mix"], hn, cache, pos, cfg,
                                             window=_window(kind, cfg), tp=tp, sv=sv)
    return _ffn_residual(kind, p, h + mix, cfg, hooks)[0], cache


def _sharded_block(kind, p, specs, h, positions, cfg, ctx, plan):
    """One block under ``plan``: its weights gathered (FSDP, kv heads) and
    run with its hooks, inside the block's checkpoint."""
    p, hooks = plan.block(kind, p, specs)
    return block_train(kind, p, h, positions, cfg, ctx, hooks)


def forward_hidden(params, cfg, tokens: torch.Tensor, ctx=None, plan=None):
    """Backbone forward to the final normed hidden state (B, S, d) and the
    aux loss summed over layers; no head (the chunked loss applies it per
    sequence chunk). tokens: (B, S), or (B, S, K) with codebooks; ``ctx``:
    the cross-attention context (B, N, d) or None. -> (h, aux).

    ``plan`` (``models.parallel.Plan``): ``params`` are a rank's blocks and
    ``tokens`` its rows; each layer gathers its weights inside its
    checkpoint (the recompute gathers again), and the activations between
    layers are checked to hold the rank's rows (``context.constrain``)."""
    h = CTX.constrain(_embed(params, cfg, tokens, plan))
    b, s = tokens.shape[:2]
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, (kind, p) in enumerate(zip(cfg.pattern_layers, params["layers"])):
        if plan is not None:
            args = (_sharded_block, kind, p, plan.specs["layers"][i], h, positions, cfg, ctx,
                    plan)
        else:
            args = (block_train, kind, p, h, positions, cfg, ctx)
        if cfg.remat:
            h, a = checkpoint(*args, use_reentrant=False)
        else:
            h, a = args[0](*args[1:])
        h = CTX.constrain(h)
        aux = aux + a
    return _final_norm(params, cfg, h, plan), aux


def forward(params, cfg, tokens: torch.Tensor, ctx=None):
    """Teacher-forcing forward. tokens: (B, S) or (B, S, K) -> (logits (B,
    S, vocab_size) or (B, S, K, vocab_size) f32, aux f32 scalar)."""
    h, aux = forward_hidden(params, cfg, tokens, ctx)
    return _head_public(params, cfg, h), aux


def make_caches(cfg, batch: int, s_max: int, device) -> dict:
    return {"layers": [block_make_cache(kind, batch, s_max, cfg, device)
                       for kind in cfg.pattern_layers]}


def prefill(params, cfg, tokens: torch.Tensor, caches: dict, ctx=None, plan=None):
    """Run the prompt, (B, S) or (B, S, K) tokens, filling caches. Returns
    (last-token logits (B, 1, V) or (B, 1, K, V), caches).

    ``plan`` (``models.parallel.Plan.for_caches``): ``params``
    and ``caches`` are the rank's blocks and ``tokens`` its rows; each
    block runs as ``Plan.serve_block`` lays it out (its gathered weights
    freed before the next block's gather), and the logits are the rank's
    columns of the padded vocabulary (``launch.steps.make_prefill_step``
    gathers them)."""
    h = _embed(params, cfg, tokens, plan)
    b, s = tokens.shape[:2]
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    filled = []
    for i, (kind, p, cache) in enumerate(zip(cfg.pattern_layers, params["layers"],
                                             caches["layers"])):
        hooks = None
        if plan is not None:
            p, hooks = plan.serve_block(i, p)
        h, cache = block_fill_cache(kind, p, h, positions, cache, cfg, ctx, hooks)
        filled.append(cache)
    del p  # under a plan the last block's gathered weights, freed before the head
    return _serve_logits(params, cfg, h[:, -1:], plan), {"layers": filled}


def decode_step(params, cfg, token_t: torch.Tensor, caches: dict, pos: int, ctx=None,
                plan=None):
    """One token step. token_t: (B, 1) or (B, 1, K); pos: the absolute
    position of this token; ``ctx`` is accepted for the reference's
    signature (the cross-attention layers read their caches). Returns
    (logits (B, 1, V) or (B, 1, K, V), a new caches dict); the dict
    given is not changed, and its SSM and RG-LRU caches' tensors are not
    written (see the module doc). ``plan``: the sharded step
    (``prefill``'s): ``token_t`` the rank's rows, the logits the rank's
    columns (``launch.steps.make_decode_step`` gathers them, or takes the
    greedy token from them)."""
    h = _embed(params, cfg, token_t, plan)
    stepped = []
    for i, (kind, p, cache) in enumerate(zip(cfg.pattern_layers, params["layers"],
                                             caches["layers"])):
        hooks = None
        if plan is not None:
            p, hooks = plan.serve_block(i, p)
        h, cache = block_decode(kind, p, h, cache, pos, cfg, hooks)
        stepped.append(cache)
    del p  # under a plan the last block's gathered weights, freed before the head
    return _serve_logits(params, cfg, h, plan), {"layers": stepped}

"""Serving driver: batched prefill + decode with resident caches.

Port of ``repro/launch/serve.py``. A request queue is packed into fixed
slots; each engine step decodes one token for every slot.

  Engine.serve        -- the plain loop (a short last wave is padded with
                         MASKED dummy slots, never duplicated requests).
  GuardedEngine + runtime.ServingRuntime -- the resilient path (--guard):
                         bounded admission, per-request deadlines, the
                         census-guarded step (every step's logit statistic
                         rides ``reduce_tree(census=True)``: one kernel
                         launch on cuda_fused), and the per-backend circuit
                         breaker degrading cuda_fused -> mma_torch -> torch.

Engines run on the GPU unless the caller passes ``device="cpu"``; with no
GPU and no device they raise. Everything runs under inference mode. An
engine whose parameters and caches would not fit the card
(``serve_state_bytes``: dbrx-132b's 263 GB at full depth) is refused
before anything is allocated; it serves only across cards, the ROADMAP's
sharding item (FSDP/TP and expert parallelism). A cross-attention arch (llama-3.2-vision-11b) serves
against one synthetic image context per slot (``Engine.ctx``); an audio
arch (musicgen-medium) takes (L, n_codebooks) prompts or tiles 1-D ones
over its streams, and reports codebook 0.

  python -m repro_torch.launch.serve --arch olmo-1b --guard \\
      --requests 8 --batch-slots 4 --prompt-len 256 --max-new 16
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import reduce as R
from repro_torch.configs import get_arch
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import init_params
from repro_torch.models.frontends import synth_image_embeds
from repro_torch.models.model import f32_param_count, param_dtype, stored_param_count
from repro_torch.models.rglru import _width as rglru_width
from repro_torch.models.ssm import _dims as ssm_dims
from repro_torch.runtime.serving import Request, ServingRuntime, guarded_logit_stat


def resolve_device(device) -> torch.device:
    """``None`` -> the GPU; a GPU request with no GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the engine runs on the GPU unless "
            "it is given device='cpu'"
        )
    return dev


def cache_bytes(cfg, kind: str, batch_slots: int, s_max: int) -> int:
    """Bytes of one layer's cache (``models.model.block_make_cache``): k and
    v, or MLA's latent (kv_lora + rope values a token), with the int32
    slot positions -- a local-attention layer's over its ring of
    min(s_max, window) slots; a cross-attention layer's k and v of the
    n_img_tokens context slots; an SSM or RG-LRU block's conv window at the
    parameters' dtype and its f32 state, whatever the sequence length."""
    item = torch.empty((), dtype=param_dtype(cfg)).element_size()
    if kind == "ssm":
        s, _, nh, conv_dim = ssm_dims(cfg)
        return batch_slots * ((s.conv_width - 1) * conv_dim * item + nh * s.headdim * s.d_state * 4)
    if kind == "rec":
        w = rglru_width(cfg)
        return batch_slots * ((cfg.rglru.conv_width - 1) * w * item + w * 4)
    if kind == "xattn":
        return batch_slots * cfg.n_img_tokens * 2 * cfg.n_kv_heads * cfg.d_head * item
    if kind == "local_attn" and cfg.window:
        s_max = min(s_max, cfg.window)
    if cfg.mla is not None:
        per_token = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    else:
        per_token = 2 * cfg.n_kv_heads * cfg.d_head
    return batch_slots * s_max * per_token * item + s_max * 4


def serve_state_bytes(cfg, batch_slots: int, s_max: int) -> int:
    """Bytes an engine holds before it serves: the parameters at their
    dtype (``stored_param_count``: the padded vocabulary rows included; the
    MoE routers, the SSM blocks' dt_bias, A_log and D and the RG-LRU
    blocks' lam at f32), every layer's cache of ``batch_slots`` x ``s_max``
    (``cache_bytes``) and a cross-attention arch's context, (batch_slots,
    n_img_tokens, d_model) at the parameters' dtype."""
    item = torch.empty((), dtype=param_dtype(cfg)).element_size()
    params = stored_param_count(cfg) * item + f32_param_count(cfg) * (4 - item)
    ctx = batch_slots * cfg.n_img_tokens * cfg.d_model * item
    return params + ctx + sum(cache_bytes(cfg, kind, batch_slots, s_max)
                              for kind in cfg.pattern_layers)


def check_fits_card(cfg, batch_slots: int, s_max: int, device: torch.device) -> None:
    """Refuse, before any allocation, an engine larger than the card."""
    if device.type != "cuda":
        return
    need = serve_state_bytes(cfg, batch_slots, s_max)
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise ValueError(
            f"{cfg.name}: the parameters and caches take {need / 1e9:.1f} GB, more than the "
            f"card's {have / 1e9:.1f} GB; it serves at this depth only across cards, when the "
            f"ROADMAP's sharding item (FSDP/TP and expert parallelism) shards it")


def _tok_ints(tok: torch.Tensor) -> np.ndarray:
    """Per-slot int tokens from a (B, 1) or (B, 1, K) greedy-argmax output
    (an audio arch reports codebook 0, as the reference does)."""
    tok = tok[:, 0]
    return (tok if tok.ndim == 1 else tok[:, 0]).cpu().numpy()


class Engine:
    """Greedy decoding engine over fixed batch slots. ``params`` (e.g. from
    ``models.convert.params_from_jax``) replaces the seeded random init. A
    cross-attention arch holds one context, ``ctx``, (slots, n_img_tokens,
    d_model) from a generator seeded 1 (the reference's engine draws its
    from key 1), passed to every prefill and decode; a caller may replace
    it."""

    def __init__(self, cfg, s_max: int, batch_slots: int, seed: int = 0, *,
                 device=None, params=None):
        self.cfg = cfg
        self.s_max = s_max
        self.slots = batch_slots
        self.device = resolve_device(device)
        if params is None:
            check_fits_card(cfg, batch_slots, s_max, self.device)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self.ctx = None
        if cfg.n_img_tokens:
            gen = torch.Generator(device=self.device).manual_seed(1)
            self.ctx = synth_image_embeds(gen, batch_slots, cfg.n_img_tokens, cfg.d_model,
                                          param_dtype(cfg), self.device)
        self._prefill_step = make_prefill_step(cfg, s_max)
        self._decode_step = make_decode_step(cfg)
        self._decode_logits_step = make_decode_step(cfg, greedy=False)

    def _prefill(self, params, tokens):
        return self._prefill_step(params, tokens, self.ctx)

    def _decode(self, params, caches, token, pos: int):
        return self._decode_step(params, caches, token, pos, self.ctx)

    def _decode_logits(self, params, caches, token, pos: int):
        return self._decode_logits_step(params, caches, token, pos, self.ctx)

    def check_fits(self, prompt_len: int, max_new: int) -> None:
        """A prompt + its generation + the one trailing decode position must
        fit the resident caches."""
        need = int(prompt_len) + int(max_new) + 1
        if need > self.s_max:
            raise ValueError(
                f"prompt_len ({prompt_len}) + max_new ({max_new}) + 1 = "
                f"{need} exceeds the engine's cache length s_max="
                f"{self.s_max}; shorten the request or rebuild the engine"
            )

    def _pack_wave(self, wave: list) -> torch.Tensor:
        """Stack a wave of prompts into (slots, L), padding the tail with
        MASKED dummy slots (zero prompts). An audio arch's prompts are (L,
        K) codebook tokens; a 1-D prompt is tiled over the K streams, as
        the reference tiles it."""
        if len(wave) < self.slots:
            dummy = np.zeros_like(np.asarray(wave[0]))
            wave = list(wave) + [dummy] * (self.slots - len(wave))
        prompts = np.stack([np.asarray(w) for w in wave]).astype(np.int64)
        if self.cfg.n_codebooks and prompts.ndim == 2:
            prompts = np.tile(prompts[..., None], (1, 1, self.cfg.n_codebooks))
        return torch.from_numpy(prompts).to(self.device)

    def serve(self, requests: list, max_new: int) -> list:
        """Greedy tokens for each request (prompts of one length)."""
        out: list = []
        for r in requests:
            self.check_fits(np.asarray(r).shape[0], max_new)
        queue = list(requests)
        with torch.inference_mode():
            while queue:
                wave, queue = queue[: self.slots], queue[self.slots:]
                prompts = self._pack_wave(wave)
                logits, caches = self._prefill(self.params, prompts)
                tok = torch.argmax(logits, -1).to(torch.int32)
                gen = [tok]
                pos = prompts.shape[1]
                for t in range(max_new - 1):
                    tok, caches = self._decode(self.params, caches, gen[-1], pos + t)
                    gen.append(tok)
                toks = np.stack([_tok_ints(g) for g in gen], 1)
                out.extend(list(toks[: len(wave)]))
        return [list(map(int, o)) for o in out]


class GuardedEngine(Engine):
    """``runtime.serving`` protocol over the prefill/decode pair.

    Each step is: model step + the chaos scale multiply (x1.0 is bitwise
    identity) + the per-slot logit statistic with its in-launch non-finite
    census (``guarded_logit_stat`` on the breaker's backend) + the greedy
    argmax. The KV (full or ring) and MLA latent caches are written in
    place; a retried step from the committed state rewrites the same slot
    with the same values (idempotent, see ``models.attention``); the
    cross-attention caches are only read. The SSM and RG-LRU caches are
    never written: a step returns new conv and state tensors
    (``models.ssm.ssm_decode``, ``models.rglru.rglru_decode``), so the
    committed state stays as it was until the runtime commits the new one.
    Either way a retried step reproduces the clean step bitwise."""

    def validate(self, prompt, max_new: int):
        try:
            self.check_fits(np.asarray(prompt).shape[0], max_new)
        except ValueError as e:
            return str(e)
        return None

    def _scales(self, scales) -> torch.Tensor:
        s = np.ones((self.slots,), np.float32)
        s[: len(scales)] = np.asarray(scales, np.float32)[: self.slots]
        return torch.from_numpy(s).to(self.device)

    @staticmethod
    def _scale_logits(logits, scales):
        return logits * scales.reshape((-1,) + (1,) * (logits.ndim - 1)).to(logits.dtype)

    def _guard(self, logits, scales, backend):
        logits = self._scale_logits(logits, self._scales(scales))
        _stat, census = guarded_logit_stat(logits, backend=backend)
        tok = torch.argmax(logits, -1).to(torch.int32)
        return tok, census.cpu().numpy()

    # -- the ServingRuntime protocol --------------------------------------

    def start_wave(self, prompts: list, scales, backend: str):
        live = [p for p in prompts if p is not None]
        if not live:
            raise ValueError("start_wave needs at least one live prompt")
        with torch.inference_mode():
            packed = self._pack_wave([np.asarray(p) for p in live])
            logits, caches = self._prefill(self.params, packed)
            tok, census = self._guard(logits, scales, backend)
        state = {"caches": caches, "tok": tok, "pos": int(packed.shape[1]), "t": 0}
        return state, _tok_ints(tok), census

    def decode(self, state: dict, scales, backend: str):
        with torch.inference_mode():
            logits, caches = self._decode_logits(
                self.params, state["caches"], state["tok"], state["pos"] + state["t"]
            )
            tok, census = self._guard(logits, scales, backend)
        new_state = {"caches": caches, "tok": tok, "pos": state["pos"], "t": state["t"] + 1}
        return new_state, _tok_ints(tok), census



def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reduce-backend", default=None,
                    choices=R.available_backends() + ("auto",),
                    help="process-wide reduce backend (default: auto)")
    ap.add_argument("--guard", action="store_true",
                    help="serve through the resilient runtime (admission "
                    "queue, deadlines, census-guarded decode, breaker)")
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline, seconds from submission")
    ap.add_argument("--chaos", action="store_true",
                    help="per-request fault injection (--guard only)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--status-path", default=None,
                    help="atomic JSON ServeMetrics export path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                    "kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.reduce_backend:
        R.set_default_backend(args.reduce_backend)
    cfg = get_arch(args.arch, tiny=args.tiny)
    s_max = args.prompt_len + args.max_new + 1
    rng = np.random.default_rng(0)
    reqs = [
        rng.integers(0, cfg.vocab_size, size=(args.prompt_len,)).astype(np.int32)
        for _ in range(args.requests)
    ]
    t0 = time.time()
    if args.guard:
        from repro_torch.runtime.chaos import ChaosMonkey

        eng = GuardedEngine(cfg, s_max, args.batch_slots, device=args.device)
        chaos = (
            ChaosMonkey.from_seed(
                args.chaos_seed, n_steps=args.requests,
                nan_rate=0.15, fail_rate=0.15, preempt_rate=0.1,
            )
            if args.chaos else None
        )
        runtime = ServingRuntime(
            eng, queue_capacity=args.queue_capacity, chaos=chaos,
            status_path=args.status_path,
        )
        now = runtime.clock()
        results = runtime.serve([
            Request(
                rid=i, prompt=p, max_new=args.max_new,
                deadline_s=(now + args.deadline_s if args.deadline_s is not None else None),
            )
            for i, p in enumerate(reqs)
        ])
        dt = time.time() - t0
        outs = [list(r.tokens) for r in results if r.ok]
        n_tok = sum(len(o) for o in outs)
        snap = runtime.metrics.snapshot()
        print(f"served {len(outs)}/{len(reqs)} requests, {n_tok} tokens in "
              f"{dt:.2f}s ({n_tok / max(dt, 1e-9):.1f} tok/s incl. init)")
        print(f"admitted={snap['admitted']} shed={snap['shed_queue_full']}"
              f"+{snap['shed_infeasible']} deadline_missed="
              f"{snap['deadline_missed']} quarantined={snap['quarantined']} "
              f"breaker_trips={snap['breaker_trips']} "
              f"p50={snap['token_latency_p50_s'] * 1e3:.1f}ms "
              f"p99={snap['token_latency_p99_s'] * 1e3:.1f}ms")
        return results
    eng = Engine(cfg, s_max, args.batch_slots, device=args.device)
    outs = eng.serve(reqs, args.max_new)
    dt = time.time() - t0
    n_tok = sum(len(o) for o in outs)
    print(f"served {len(outs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s incl. init)")
    for i, o in enumerate(outs[:3]):
        print(f"req{i}: {o[:12]}...")
    return outs


if __name__ == "__main__":
    main()

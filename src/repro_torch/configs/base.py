"""Model and shape configuration: a frozen, hashable ``ModelConfig`` per
architecture, the four assigned ``ShapeConfig`` cells.

A copy of ``repro/configs/base.py`` restricted to what the decoders of
this package need (the dense and MoE FFNs, MLA, the Mamba-2 SSM block, the
RG-LRU block with local attention, vision cross-attention and the audio
codebook streams), plus the optimizer's ``TrainConfig`` and the shape
cells with ``shape_applicable``.
``use_pallas`` is ``use_kernels`` here and defaults to True: the hot spots
(norms, attention, the cross-entropy, the loss and clip statistics) run on
the CUDA kernels of ``repro_torch.kernels``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD hyperparameters."""

    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """Griffin / RecurrentGemma RG-LRU block."""

    lru_width: int = 0          # 0 -> d_model
    conv_width: int = 4
    c: float = 8.0              # Griffin's fixed decay sharpness


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # Repeating layer pattern cycled to n_layers (tail truncated). Kinds:
    # "attn" (global self-attention, or MLA when ``mla`` is set, + FFN),
    # "local_attn" (self-attention within ``window`` + FFN), "xattn"
    # (cross-attention to the frontend's embeddings + FFN), "ssm" (the
    # Mamba-2 block, no FFN), "rec" (the RG-LRU block + FFN).
    block_pattern: tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_np
    ffn_kind: str = "swiglu"       # swiglu | gelu
    window: Optional[int] = None   # local_attn window size
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    n_img_tokens: int = 0          # vision frontend tokens (the xattn context)
    n_codebooks: int = 0           # audio codebook streams (musicgen)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # tanh soft cap of the logits, c * tanh(logits / c); 0 = off (the reference's)
    logits_softcap: float = 0.0
    # --- framework knobs (not architecture) ---
    dtype: str = "bfloat16"        # params/activations dtype
    use_kernels: bool = True       # route hot spots to the CUDA kernels
    mma_reductions: bool = True    # paper's technique on/off (off = baseline)
    remat: bool = True             # activation checkpointing per layer

    @property
    def pattern_layers(self) -> tuple[str, ...]:
        reps = -(-self.n_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]

    @property
    def attention_free(self) -> bool:
        return all(k in ("ssm", "rec") for k in self.pattern_layers)

    @property
    def subquadratic(self) -> bool:
        """True if the arch decodes with O(1)-or-bounded state per token:
        every layer an SSM or recurrent block, or local attention with a
        window (mamba2-780m, recurrentgemma-9b)."""
        return all(
            k in ("ssm", "rec") or (k == "local_attn" and self.window)
            for k in self.pattern_layers
        )

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head), the
        reference's formula for every block kind: self-attention, global
        or local (MLA when ``mla`` is set), and cross-attention, each with
        a dense or MoE FFN; the SSM block (whose last term, ``d_in + 2 nh``,
        is the reference's approximation: the block holds ``d_in + 3 nh``
        such values, ``A_log``, ``D`` and ``dt_bias``); the RG-LRU block
        with its FFN (whose ``3 w`` is the reference's approximation for
        ``gate_a``, ``gate_x`` and ``lam``, which hold ``2 w^2 / 16 + w``
        values); K codebook streams add K - 1 embedding tables and K - 1
        heads. ``models.model.stored_param_count`` counts what is
        stored."""
        d = self.d_model
        total = self.vocab_size * d  # embed
        if self.n_codebooks:
            total += (self.n_codebooks - 1) * self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d * max(1, self.n_codebooks or 1)
        for kind in self.pattern_layers:
            if kind in ("attn", "local_attn"):
                if self.mla is not None:
                    m = self.mla
                    total += d * m.q_lora_rank
                    total += m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    total += d * (m.kv_lora_rank + m.qk_rope_dim)
                    total += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d
                else:
                    total += d * self.n_heads * self.d_head
                    total += 2 * d * self.n_kv_heads * self.d_head
                    total += self.n_heads * self.d_head * d
                total += self._ffn_params()
            elif kind == "xattn":
                total += d * self.n_heads * self.d_head
                total += 2 * d * self.n_kv_heads * self.d_head
                total += self.n_heads * self.d_head * d
                total += self._ffn_params()
            elif kind == "ssm":
                s = self.ssm
                d_in = s.expand * d
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                nh = d_in // s.headdim
                total += d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                total += conv_dim * s.conv_width
                total += d_in * d
                total += d_in + 2 * nh  # gated-norm gamma + A, D, dt_bias approx
            elif kind == "rec":
                r = self.rglru or RGLRUConfig()
                w = r.lru_width or d
                total += 2 * d * w + w * d + r.conv_width * w + 3 * w
                total += self._ffn_params()
        return int(total)

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            e = self.moe
            per = 3 * d * e.d_ff_expert if self.ffn_kind == "swiglu" else 2 * d * e.d_ff_expert
            return e.n_experts * per + d * e.n_experts
        return 3 * d * self.d_ff if self.ffn_kind == "swiglu" else 2 * d * self.d_ff

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the top-k experts), the
        N of MODEL_FLOPS = 6 N_active D."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        per = (3 if self.ffn_kind == "swiglu" else 2) * self.d_model * e.d_ff_expert
        n_ffn_layers = sum(
            1 for k in self.pattern_layers if k in ("attn", "local_attn", "xattn"))
        return int(self.param_count() - n_ffn_layers * (e.n_experts - e.top_k) * per)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.mode == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


# The four assigned LM shape cells (the reference's).
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention; decoders run all other
    cells. Returns (runs, reason-if-skipped)."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, ("full attention: 500k dense KV decode is the quadratic regime the "
                       "spec excludes")
    return True, ""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """AdamW and schedule settings: ``repro.configs.base.TrainConfig``
    without ``grad_compression`` (the cross-pod gradient hop is not ported).
    """

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1          # gradient-accumulation chunks per step
    # olmax-style scalar second-moment EMA per reference leaf, fed by the
    # norm launch's per-leaf sumsq slots (see optim.adamw); must match the
    # init_state that built the opt state
    fused_second_moment: bool = False
    seed: int = 0

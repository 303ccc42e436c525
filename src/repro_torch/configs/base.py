"""Model and shape configuration: a frozen, hashable ``ModelConfig`` per
architecture, the four assigned ``ShapeConfig`` cells.

A copy of ``repro/configs/base.py`` restricted to what the dense and MoE
decoders of this package need (``SSMConfig``, ``MLAConfig`` and
``RGLRUConfig`` come with the families that use them), plus the
optimizer's ``TrainConfig`` and the shape cells with ``shape_applicable``.
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
class ModelConfig:
    name: str
    family: str                    # dense | moe (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # Repeating layer pattern cycled to n_layers; only "attn" (global
    # self-attention + FFN) is ported.
    block_pattern: tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"          # rmsnorm | layernorm_np
    ffn_kind: str = "swiglu"       # swiglu | gelu (gelu: the MoE experts only)
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
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
    def subquadratic(self) -> bool:
        """True if the arch decodes with bounded state per token (SSM or
        recurrent state, or a bounded local window): none of the ported
        blocks, so False for every ported config."""
        return all(k in ("ssm", "rec") for k in self.pattern_layers)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head), the same
        formula as the reference for the attention block with a dense or
        MoE FFN."""
        d = self.d_model
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for kind in self.pattern_layers:
            if kind != "attn":
                raise NotImplementedError(
                    f"block kind {kind!r} is not ported; only 'attn' is"
                )
            total += d * self.n_heads * self.d_head
            total += 2 * d * self.n_kv_heads * self.d_head
            total += self.n_heads * self.d_head * d
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
        n_ffn_layers = sum(1 for k in self.pattern_layers if k == "attn")
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

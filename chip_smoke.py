#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch version at the full-width
shapes of the serving and training paths (olmo-1b: d_model 2048, 16 heads
of 128, vocab 50304 padded to 50432, bf16; internlm2-1.8b: RMSNorm at
2048, 16 query heads on 8 kv heads, vocab 92544 padded to 92672;
deepseek-7b: RMSNorm at 4096, 32 heads; granite-moe-1b-a400m: RMSNorm at
1024, 16 query heads on 8 kv heads of 64, vocab 49155 padded to 49408;
dbrx-132b: RMSNorm at 6144, 48 query heads on 8 kv heads, vocab 100352;
minicpm3-4b: RMSNorm at 2560, vocab 73448 padded to 73472; mamba2-780m:
RMSNorm at 1536, vocab 50280 padded to 50432; attention at head widths 8
and 24, which the wrapper pads, and 136, 144, 200 and 256 on the kernel's
wide variant, timed at recurrentgemma-9b's 16 query heads on 1 kv head of
256, also with its window of 2048 past it, at 2304 tokens (and checked at
2200); recurrentgemma-9b
and llama-3.2-vision-11b: RMSNorm at 4096, vocabularies 256000 and
128256, vision's 32 query heads on 8 kv heads of 128)
and of the paper's reduction (n = 2^28) and times it, checks tiny and
2-layer models end to end against the CPU (serving and training; tiny
olmo, internlm2, deepseek, granite-moe, dbrx, minicpm3 and mamba2, the MoE
archs' routing tables equal on both devices, each arch's logit limit
failed by a planted fault) and the reduction engine card against CPU,
then drives the main paths with every kernel launch counted by the launch
meter (``repro_torch.reduce.inspect.count_kernel_launches``):

  meter     ``measured_hbm_bytes`` of ``reduce`` on cuda_hier and on
            cuda_fused's one-lane finish equal to ``ReducePlan.hbm_bytes
            (...).launch_io`` at 2^28 f32 and bf16 (cuda_fused at the
            device's lanes against ``cost_model.fused_launch_bytes``), and
            ``assert_staging_free`` on the kernel routes of ``reduce``,
            ``reduce_many`` and ``reduce_tree``;
  autotune  ``reduce.autotune`` at 2^28 f32 and bf16: the winner and its
            time beside the untuned auto plan's, and ``plan_for`` returning
            the winner from its memo;
  serving   full-width olmo-1b, internlm2-1.8b and deepseek-7b (in that
            order, each engine freed before the next) through the guarded
            runtime (8 requests, prompt 256, 16 new tokens, 4 slots), the
            launches held to the config's model (``launches_per_step``:
            K5b for RMSNorm, K5a for OLMo's LayerNorm); then the MoE archs:
            full-depth granite-moe-1b-a400m and dbrx-132b at full width cut
            to 2 layers (its full depth refused before any allocation),
            each with no kernel launched outside the model, two prefills
            bitwise equal and the drop fraction at the prefill; then
            full-depth minicpm3-4b (MLA: no K6, the chunked attention) and
            mamba2-780m (the SSM: no K6, no FFN), two prefills bitwise
            equal, and for mamba2 a decode step retried from its committed
            state bitwise the clean one; then full-depth recurrentgemma-9b
            (38 layers: K6's wide variant with its window in the 12 local
            layers, the RG-LRU's scan in torch) with its retried decode
            bitwise, and its ring case: 4 prompts of 2304 tokens, past the
            window of 2048, and 16 decoded tokens (the ring wraps) against
            a teacher-forcing forward on the card, a ring filled at slot pos
            planted to fail the limit; then full-depth
            llama-3.2-vision-11b (40 layers, a synthetic 1032-token image
            context a slot), and with its cross-attention gates opened to
            0.5 its decode against the forward, the cross-attention's k and
            v from the next kv head planted to fail the limit;
  training  full-width olmo-1b, batch 4 x seq 512, 3 AdamW steps through
            ``python -m repro_torch.launch.train``'s ``main`` with
            ``--reduce-backend cuda_fused``; then one step profiled; the
            same for internlm2-1.8b, plus one ``--guard`` step: its 219
            gradient leaves take the clip statistic past K4's 128 parts
            (the f32 pack, one K8 launch, the host census), whose bytes,
            launches and device time are printed beside olmo's K4; the
            same for granite-moe-1b-a400m (242 leaves), with its aux term
            finite and non-zero, for mamba2-780m (482 leaves) and for
            minicpm3-4b at full width cut to 16 of 62 layers (195 leaves;
            its full depth refused by the CLI before any allocation); the
            same for recurrentgemma-9b cut to 3 of 38 layers (36 leaves)
            and llama-3.2-vision-11b cut to 10 of 40 (95 leaves), their
            clip statistics one K4 launch; every training run's peak
            device memory printed beside the fit check's model of the step
            (``launch.train.train_step_peak_bytes``) and its activation
            reserve, which must hold it;
  fit       recurrentgemma-9b at the deepest whole unit of 3 layers that
            ``launch.train.check_fits_card`` accepts, one plain step (6
            layers on an 80 GB card) and one guarded (3), the next unit
            refused by the CLI before any allocation;
  examples  the reference's examples through the port's entry points
            (``run_examples_phase``): ``examples.quickstart`` (K1's sum of
            2^20 numbers against the exact sum of its bf16 operands, tiny
            olmo-1b's 10 steps with a falling loss),
            ``examples.serve_batched`` (6 and 4 outputs of 8 tokens, the
            same on a rerun) and ``examples.train_100m`` at its defaults:
            llama-110m at full width, 300 steps of 8 x 512 with a falling
            loss, its launches a step held to the launch model (K5b 49, K6
            24 at 12 heads of 64, K7 2, K1 1, K4 1), the loss every 30
            steps, the step wall's p50, the steps a second and the peak
            memory; K6, K7 and K4 at its shapes (``check_llama_110m_shapes``);
  paper     ``python -m repro_torch.launch.reduce_demo``'s ``main`` at
            n = 2^28: step counts, precision and time per backend, through
            the hierarchy's level kernel (K10), the moments kernel (K2)
            and the Kahan kernel (K3), its segmented section, and the
            card's roofline (``core.cost_model.gpu_reduction_roofline``)
            with K1 and K10 timed at f32 and bf16 as shares of their cold
            bound: a share under 0.95 (``ROOFLINE_FLOOR``) fails the run;
  multi     the multi-reduce and scan path: ``reduce_many`` over 2^28 f32
            values in 2048 packed ragged segments (the pack and one launch
            of the gather kernel, K8), ``reduce_many`` kinds sum and
            moments over full-width olmo-1b's 113 parameter leaves (the
            parts kernel, K4, at bf16 compute), ``repro_torch.scan`` over
            2^28 f32 and bf16 values (the scan kernel, K9) and
            ``packing_offsets`` of 2048 lengths on ``cuda_fused``;
  matmul    the K11 entry, ``repro_torch.kernels.matmul_stats``, at
            olmo-1b's MLP down projection, (2048 x 8192) @ (8192 x 2048)
            at bf16 and f32 and the serving prefill's 1024 rows at bf16
            (the fused matmul with its row moments, K11); checked also at
            full width on the element loads (x 2 bytes past a 16-byte
            boundary, and K = 8190);
  non-kernel full-depth olmo-1b on 4 x 512 tokens through ``models.forward``
            and ``lm_loss`` with ``use_kernels=False``, the paper's
            technique on (``mma_torch``) and off (``torch``), against the
            kernel route from the same weights;
  guarded   full-width olmo-1b, batch 4 x seq 512, 3 guarded steps through
            the training CLI's ``main`` (``--guard``, NaN on step 2): the
            census (K4, one launch a step) finds it and the step is
            skipped; a clean guarded step equals a plain step bitwise, a
            poisoned one leaves the state bitwise; the guarded step's
            device time, and K4's with and without the census;
  rollback  olmo-1b at full width cut to 2 layers through ``main`` with
            ``--guard --ckpt-dir``: NaN on three steps in a row, a rollback
            to the step-0 anchor, the replay's losses bitwise the first
            run's, a truncated shard caught and ``restore_latest_valid``
            falling back; the checkpoints' bytes and seconds;
  data mesh the port's data-parallel guarded path (``run_data_mesh_phase``):
            the engine's ``reduce_tree(census=True, mesh_axes="data")``
            over olmo-1b's 113 f32 leaves split by rows, under NCCL at
            world min(device_count, 4) and under gloo at world 2 with both
            ranks on card 0 (the same bits on every rank and in two runs,
            within ``budget_for`` of the world-1 value, one K4 launch a
            rank, census exact with a planted NaN, received bytes equal to
            ``interconnect_bytes``), NCCL refused for two ranks on one
            card, one-ulp faults planted on rank 1 caught by
            ``replica_bits_agree``, ``census_agreement`` and the checker;
            then ``launch.train --arch olmo-1b --guard --mesh --chaos-host
            1`` at full width cut to 2 layers on two gloo ranks sharing
            the first card (batch 2 + 2 x 512; rank 1 poisoned on step 2,
            skipped on both ranks with the parameters bitwise, a rollback
            at the same step on both, every step's metrics printed bitwise
            the same, an agreement round over ``FileTransport`` a step, the
            combine's metered bytes equal to ``interconnect_bytes``, the
            step-1 loss, grad norm and clip against the single-rank guarded
            step's at that depth), each step's wall, device busy, combine
            seconds and bytes with the transport and peak memory a rank;
            then tiny olmo-1b at world 2 on the card against CPU ranks;
  sharded   the sharded step (``run_sharded_phase``): four gloo ranks
            sharing the first card, in one spawn, train at full width on a
            (data 2, model 2) mesh deepseek-7b at 3 layers (FSDP + TP +
            vocab TP), granite-moe-1b-a400m at 6 of 24 layers (FSDP +
            vocab TP + EP), minicpm3-4b at 1 (MLA's TP),
            llama-3.2-vision-11b at 5 (cross-attention's TP, its gates
            open), mamba2-780m at 2 (the SSM's TP) and musicgen-medium at
            2 (SMALL_MODEL_RULES: the codebook streams vocab-parallel, the
            fused second moment), and on (data 1, model 4)
            recurrentgemma-9b at 3 (the RG-LRU's channels, local
            attention's one kv head gathered), two steps each at a
            learning rate past warmup: both steps' loss, grad norm and clip
            against the single-rank step's, step 1's update of the probed
            leaves (layer 0's, the first rec and xattn block's, a codebook
            table) against the single rank's, replicated leaves bitwise
            equal across ranks, each rank's collective bytes equal to the
            dry run's model, its launches to the launch model; for the
            five new kinds step 1's gradient of the probed leaves, and a
            planted fault in each mixer's TP (musicgen's: its lookup one
            row off) that must read 10 x its limit; K7's partial variant against its plain version; the dry
            run of deepseek-7b train_4k on (2, 2) and (16, 16) (a model
            figure: the step's peak, the reserve and the checkpointed
            block inputs a rank);
  sharded serving  the sharded prefill and decode steps
            (``run_sharded_serving_phase``): four gloo ranks sharing the
            first card on (data 2, model 2) serve deepseek-7b at full width
            and 3 of 30 layers (TP_ONLY_RULES: heads cut, K6 and K5b on the
            rank's heads), granite-moe-1b-a400m at full depth
            (SMALL_MODEL_RULES: weights
            whole over "model", FSDP, EP, caches cut by heads) and the MLA,
            SSM, RG-LRU, cross-attention and codebook archs, 4 prompts
            of 256 tokens and 16 teacher-forced decode steps each, against
            the single rank on the same weights: logits within a limit and
            a planted fault ten times past it, greedy tokens, a retried
            step bitwise, c10d bytes equal to the dry run's serving cell,
            launches, the peak a rank under the dry run's bytes;
  uneven heads  MLA's 40 query heads over a model axis of 3
            (``run_uneven_heads_phase``): three gloo ranks sharing the
            first card, in one spawn, train minicpm3-4b at full width and
            2 layers on (data 1, model 3) (13, 13 and 14 heads a rank,
            q_up gathered over "model", kv_up and o whole), two steps
            against the single rank as the sharded phase holds its archs,
            then serve it (4 prompts of 254 tokens, so that the 270-slot
            latent is cut by slots, and 16 decode steps: the decode's
            uneven q gather) as the sharded serving phase does; the
            planted fault: rank 1's o cut one head off its rows.

Exits nonzero, with no result line, when any check fails or there is no
GPU.

Output: the card's name and power limit (nvidia-smi), the build time, one
line per kernel check, the serving, training and paper figures, then the
kernels JSON line (each kernel timed at its main path's shapes: training
for K1/K4-K7, with serving-shape figures under "serving", and K5's
decode rows under "decode"; the paper's
n = 2^28 f32 for K2, K3, K10, with bf16 figures beside them, and K3's
one-lane route; "launches"
counts the kernel's own main path; K8 and K9 at 2^28 f32, bf16 beside;
K11 at (2048 x 8192) @ (8192 x 2048) bf16, the serving rows and f32
beside) and, last,
``{"ok": true, "device": {...}}``.

Peak rates used for the bounds are the H100 SXM data sheet's: 3.35 TB/s of
HBM, 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32 on the CUDA
cores.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# The card's rates, from the one place the repository states them.
sys.path.insert(0, SRC)
try:
    from repro_torch.core.cost_model import (  # noqa: E402
        BF16_TENSOR_FLOPS,
        F32_CUDA_CORE_FLOPS,
        HBM_BYTES_PER_S,
    )
except ImportError:  # not a checkout of the repository: main() refuses to run
    BF16_TENSOR_FLOPS = F32_CUDA_CORE_FLOPS = HBM_BYTES_PER_S = None

# The serving run: full-width olmo-1b, depth as published.
SLOTS, PROMPT, MAX_NEW, REQUESTS = 4, 256, 16, 8
WAVES = -(-REQUESTS // SLOTS)


# The training run: full-width olmo-1b, depth as published.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3
LOSS_CHUNK = 512  # models.losses.lm_loss_chunked's seq_chunk


def _norm_kernels(cfg, per: int) -> dict:
    """``per`` launches of the config's norm kernel (K5b for RMSNorm, K5a
    for OLMo's non-parametric LayerNorm) and none of the other; a LayerNorm
    with a scale and a bias launches neither: its moments are the engine's
    row reductions (a ones-product in torch on every backend), as in the
    reference, whose kernel route takes only the other two."""
    return {"rmsnorm": per if cfg.norm == "rmsnorm" else 0,
            "layernorm_np": per if cfg.norm == "layernorm_np" else 0}


def clip_statistic_kernels(cfg) -> dict:
    """The clip statistic's launches a step: one parts launch (K4) up to
    ``PARTS_KERNEL_MAX`` gradient leaves; past it the tree is packed at f32
    and summed by one segmented gather (K8), the reference's route past its
    kernel's table."""
    from repro_torch.kernels.mma_reduce import PARTS_KERNEL_MAX
    from repro_torch.launch.train import param_leaves

    parts = param_leaves(cfg) <= PARTS_KERNEL_MAX
    return {"mma_sum_parts": int(parts), "mma_sum_segments": int(not parts)}


def _layer_launches(cfg) -> tuple:
    """(norm launches, attention launches) of one forward over the layers:
    norm1 in every block and norm2 in those with an FFN (all but the SSM
    block); K6 in every self-attention block, global or local (past heads
    of 128 its wide variant), but MLA's, which runs the chunked non-kernel
    attention, as the reference does (``models.mla``), as does the
    cross-attention block (``attention.cross_attention_apply``). The MLA,
    SSM and RG-LRU mixers launch no kernel: their latent and gated norms
    ride the engine's row reductions (torch ones-products on every
    backend), the SSD's decay scans over batched rows the triangular
    product (K9 takes 1-D streams only), and the RG-LRU's non-uniform
    recurrence a log-depth scan of torch ops (no ones-product encodes
    it)."""
    norms = sum(1 if kind == "ssm" else 2 for kind in cfg.pattern_layers)
    attn = sum(1 for kind in cfg.pattern_layers
               if kind in ("attn", "local_attn") and cfg.mla is None)
    return norms, attn


def _attn_kernel(cfg) -> str:
    """The profiler's name of the K6 kernel the config's heads take."""
    return "::attn_fwd_wide_kernel<" if cfg.d_head > 128 else "::attn_fwd_kernel<"


def train_launches_per_step(cfg, seq: int = TRAIN_SEQ) -> dict:
    """Kernel launches per training step under remat. Forward: the layers'
    norms plus the final norm and their attentions (``_layer_launches``);
    backward: each layer recomputed (its norms and attention again). The chunked loss runs the
    CE kernel in its forward and again in its recompute; the token sum's
    kernel runs once, because its backward reads nothing of its output and
    the recompute stops at the last tensor the backward needs. The clip
    statistic: ``clip_statistic_kernels``. An MoE FFN launches no kernel:
    its routing's row sums (the softmax denominator, the load-balance
    statistics) are the engine's row reductions, a ones-product in torch on
    every backend (``cuda_fused`` inherits ``mma_torch``'s ``sum_axis``),
    and its slot-base scan is pinned to ``mma_torch`` (``models.moe``)."""
    chunks = -(-seq // LOSS_CHUNK)
    norms, attn = _layer_launches(cfg)
    return dict(_norm_kernels(cfg, 2 * norms + 1), **clip_statistic_kernels(cfg),
                flash_attention=2 * attn, cross_entropy=2 * chunks,
                mma_sum_fused=chunks)


def launches_per_step(cfg):
    """Kernel launches per prefill and per decode step: the layers' norms
    plus the final norm, prefill attention per attention layer
    (``_layer_launches``), one logit statistic (K4 over the slots'
    logits); an MoE FFN adds none (see ``train_launches_per_step``)."""
    norms, attn = _layer_launches(cfg)
    prefill = dict(_norm_kernels(cfg, norms + 1), flash_attention=attn, mma_sum_parts=1)
    decode = dict(prefill, flash_attention=0)
    return prefill, decode


TPU_KERNELS = {
    "tile_partials": "src/repro/kernels/mma_reduce/kernel.py:131",
    "mma_moments_fused": "src/repro/kernels/mma_reduce/kernel.py:257",
    "mma_sum_kahan": "src/repro/kernels/mma_reduce/kernel.py:286",
    "layernorm_np": "src/repro/kernels/row_moments/kernel.py:57",
    "rmsnorm": "src/repro/kernels/row_moments/kernel.py:47",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:50",
    "mma_sum_parts": "src/repro/kernels/mma_reduce/kernel.py:728",
    "cross_entropy": "src/repro/kernels/cross_entropy/kernel.py:39",
    "cross_entropy_partial": "src/repro/kernels/cross_entropy/kernel.py:39",
    "mma_sum_fused": "src/repro/kernels/mma_reduce/kernel.py:186",
    "mma_sum_segments": "src/repro/kernels/mma_reduce/kernel.py:512",
    "mma_scan": "src/repro/kernels/scan.py:68",
    "matmul_stats": "src/repro/kernels/matmul_stats/kernel.py:29",
}
SOURCES = {
    "tile_partials": "src/repro_torch/kernels/csrc/tile_partials.cu",
    "mma_moments_fused": "src/repro_torch/kernels/csrc/fused_reduce.cu",
    "mma_sum_kahan": "src/repro_torch/kernels/csrc/fused_kahan.cu",
    "layernorm_np": "src/repro_torch/kernels/csrc/row_moments.cu",
    "rmsnorm": "src/repro_torch/kernels/csrc/row_moments.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "mma_sum_parts": "src/repro_torch/kernels/csrc/parts_reduce.cu",
    "cross_entropy": "src/repro_torch/kernels/csrc/cross_entropy.cu",
    "cross_entropy_partial": "src/repro_torch/kernels/csrc/cross_entropy.cu",
    "mma_sum_fused": "src/repro_torch/kernels/csrc/fused_reduce.cu",
    "mma_sum_segments": "src/repro_torch/kernels/csrc/segmented_gather.cu",
    "mma_scan": "src/repro_torch/kernels/csrc/scan.cu",
    "matmul_stats": "src/repro_torch/kernels/csrc/matmul_stats.cu",
}
KERNELS = ("mma_sum_parts", "layernorm_np", "rmsnorm", "flash_attention", "cross_entropy",
           "cross_entropy_partial", "mma_sum_fused", "mma_moments_fused", "mma_sum_kahan", "tile_partials",
           "mma_sum_segments", "mma_scan", "matmul_stats")
PAPER_KERNELS = ("mma_moments_fused", "mma_sum_kahan", "tile_partials")
MULTI_KERNELS = ("mma_sum_segments", "mma_scan")
PAPER_N = 2**28  # the reduce demo's n: 1.07 GB of f32
# The least share of its cold bound (``cost_model.gpu_reduction_roofline``)
# a measured K1 or K10 call may read: under it the bound's arithmetic is wrong.
ROOFLINE_FLOOR = 0.95
# The dense archs, each served at full width; internlm2-1.8b also trains at
# full width (deepseek-7b's training state does not fit one card).
DENSE_ARCHS = ("olmo-1b", "internlm2-1.8b", "deepseek-7b")


DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def counted_run(fn):
    """``fn()`` with every kernel launch counted by the launch meter
    (``repro_torch.reduce.inspect.count_kernel_launches``: every wrapper's
    count set to 0 just before, read just after), the card synchronised on
    both sides. Returns ``(fn's result, {kernel: launches})``. A wrapper
    that ran its plain version in the run (an operand on the CPU) launched
    nothing: the meter raises."""
    import torch

    from repro_torch.reduce.inspect import count_kernel_launches

    torch.cuda.synchronize()

    def synced():
        out = fn()
        torch.cuda.synchronize()
        return out

    return count_kernel_launches(synced)


class EventsMs(float):
    """A time taken by CUDA events (``time_ms``), not by the profiler: the
    kernels line names each time's source (``timed_by``)."""


def timed_by(ms) -> str:
    return "cuda_events" if isinstance(ms, EventsMs) else "profiler"


def time_ms(fn, iters: int = 50, warmup: int = 5) -> EventsMs:
    """Mean time of one CALL: CUDA events around ``iters`` back-to-back
    calls after ``warmup`` calls. Where the host takes longer to issue a
    call than the device to run it, this is the host's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return EventsMs(start.elapsed_time(end) / iters)


def _self_device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else getattr(evt, "self_cuda_time_total", 0.0))


# Late in this script a profiling session loses the device records of its
# first few launches, wherever they start: a llama-3.2-vision-11b decode
# step read 3001 or 3002 records where a fresh process read 3005, its first
# norm launch among the lost, in every session, also 50 ms after the
# session started; a lone launch (the clip statistic's K4) read nothing.
# So each session opens with these many spin kernels (``torch.cuda._sleep``)
# for the loss to fall on, and leaves them out of its result.
PRIMING_LAUNCHES = 32
PRIMER = "spin_kernel"


def device_events(fn, calls: int = 1) -> dict:
    """Run ``fn`` ``calls`` times under the profiler, after
    ``PRIMING_LAUNCHES`` spin kernels: ``{kernel name: (count, device
    us)}`` of every kernel, memset and copy it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMING_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, _self_device_us(e)) for e in prof.key_averages()
            if _self_device_us(e) > 0.0 and PRIMER not in e.key}


def complete_events(fn, expect, calls: int, what: str, tries: int = 3,
                    pause_s: float = 0.0) -> dict:
    """``device_events(fn, calls)`` from a session that lost none of the
    kernels named in ``expect`` (by substring): each ran ``expect[name]``
    times. A session that dropped device events (see ``device_ms``) would
    read short; it is run again, up to ``tries`` in all, ``pause_s``
    seconds after the last, then the script fails."""
    got = {}
    for attempt in range(1, tries + 1):
        if attempt > 1:
            time.sleep(pause_s)
        events = device_events(fn, calls)
        got = {name: sum(c for k, (c, _) in events.items() if name in k) for name in expect}
        if events and got == expect:
            return events
        short = {k: c for k, (c, _) in events.items()
                 if any(name in k for name, n in expect.items() if got[name] != n)}
        print(f"profiling session {attempt} of {what} is incomplete: kernel counts {got}, "
              f"expected {expect} (by name: {short}); run again")
    raise SmokeFailure(f"the profiler lost device events of {what} in {tries} sessions")


def step_events(step, per_step: dict, what: str, steps: int = 5, tries: int = 8) -> tuple:
    """The device events of ``steps`` runs of ``step``, each run profiled in
    a session of its own that must hold every kernel of ``per_step`` (name
    substring -> launches), summed. A session that lost one is run again,
    up to ``tries`` in all, a fifth of a second apart (``complete_events``):
    the tracer drops records of long sessions (8 of 9 sessions of 4 to 6
    decode steps of minicpm3-4b or mamba2-780m lost one norm launch), one
    step a session loses fewer, and the losses come in runs (5 sessions in
    a row of one llama-3.2-vision-11b decode step lost one norm launch
    each; in another run of the script none did, and a fresh process lost
    none in 12). Returns (events, steps)."""
    total: dict = {}
    for i in range(steps):
        events = complete_events(step, per_step, 1, f"{what} (run {i + 1} of {steps})", tries,
                                 pause_s=0.2)
        for key, (count, us) in events.items():
            c0, u0 = total.get(key, (0, 0.0))
            total[key] = (c0 + count, u0 + us)
    return total, steps


def device_ms(fn, match: str | None = None, iters: int = 20, warmup: int = 3,
              tries: int = 3) -> float:
    """Mean DEVICE time of one call: the profiler's device time of every
    kernel, memset and copy the call runs. Inputs stay resident in L2 where
    they fit (at most 17 MB on the serving path), as there, where the
    producer of a kernel's input has just written it.

    A profiling session can drop device events (seen on this card: 1 to 3
    of 5 launches of a 1.5 ms kernel, a few hundred of the ~1800 kernels of
    one plain-version call), and a total divided by the call count then
    reads short. So a pair of sessions whose launch counts differ (one call
    against ``iters`` calls) is run again, up to ``tries`` in all. The
    means over what such sessions did record are no time either: they have
    read K8 and K9 at 2^28 below the HBM bound. So where every pair dropped
    events, or every session came back empty (most often late in a long
    run: K11 after some hundred sessions), the call is timed by CUDA events
    instead (``time_ms``: the device's time where the call keeps it busy,
    else the host's issue time), this is printed, and the kernels line says
    so (``timed_by``). With ``match``, the call must have run a kernel
    whose name contains it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    what = match or getattr(fn, "__qualname__", "the call")
    one = many = {}
    for attempt in range(1, tries + 1):
        one, many = device_events(fn), device_events(fn, iters)
        if not (one or many):
            print(f"profiling sessions {attempt} of {what} recorded no device time")
        elif all(one.get(k, (0, 0.0))[0] * iters == many.get(k, (0, 0.0))[0]
                 for k in set(one) | set(many)):
            break
        else:
            print(f"profiling sessions {attempt} of {what}: launch counts differ (events "
                  "dropped)")
    recorded = set(one) | set(many)
    if not recorded:
        print(f"the profiler recorded no device time for {what} in {tries} sessions: timed by "
              "CUDA events")
        return time_ms(fn, iters=iters, warmup=0)
    if match is not None:
        check(any(match in k for k in recorded),
              f"the profiler recorded no device time for a kernel named {match}")
    if any(one.get(k, (0, 0.0))[0] * iters != many.get(k, (0, 0.0))[0] for k in recorded):
        print(f"profiling of {what}: launch counts differ in all {tries} pairs of sessions "
              "(events dropped): timed by CUDA events")
        return time_ms(fn, iters=iters, warmup=0)
    return sum((u1 + un) / (c1 + cn) * c1 for (c1, u1), (cn, un)
               in ((one[k], many[k]) for k in recorded)) / 1e3


def bound_ms(nbytes: float, tensor_flops: float = 0.0, core_flops: float = 0.0):
    """The least time for the work: the larger of bytes over the HBM rate
    and operations over the peak rate of their unit."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (tensor_flops / BF16_TENSOR_FLOPS + core_flops / F32_CUDA_CORE_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp_ok(got, want) -> bool:
    """Every element within one bf16 ulp of the plain version's value."""
    import torch

    g, w = got.float(), want.float()
    return bool(torch.all((g - w).abs() <= 2.0**-7 * w.abs() + 1e-6))


# ------------------------------ kernel checks --------------------------------


def check_norms(results: dict, gen) -> None:
    """K5 at decode rows, prefill rows (serving) and the training rows,
    each against its plain version, bitwise over two launches, and timed
    with its library call; then f32 and f16 input at the training rows and
    the other routes at full width: a 2-byte offset base (element route),
    d = 2050 (element route) and a row too long for the registers (the
    re-read route). Prints each call's route."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import layernorm_np, rmsnorm
    from repro_torch.kernels.row_moments import layernorm_np_plain, plan_for, rmsnorm_plain

    d = 2048
    rms_lib = getattr(F, "rms_norm", None)

    def agree(x, gamma, what):
        ln, ln_p = layernorm_np(x, 1e-5), layernorm_np_plain(x, 1e-5)
        rn, rn_p = rmsnorm(x, gamma, 1e-6), rmsnorm_plain(x, gamma, 1e-6)
        torch.cuda.synchronize()
        err_ln = float((ln.float() - ln_p.float()).abs().max())
        err_rn = float((rn.float() - rn_p.float()).abs().max())
        print(f"K5a layernorm_np {what}: max_abs_err {err_ln:.3g} vs plain (tol: 1 bf16 ulp -- "
              "both round x and x*x to bf16 and sum in f32, in different orders); "
              f"route {plan_for(x).name}")
        print(f"K5b rmsnorm      {what}: max_abs_err {err_rn:.3g} vs plain (tol: 1 bf16 ulp, "
              f"same reason); gamma {str(gamma.dtype)[6:]}, route {plan_for(x, gamma).name}")
        check(bf16_ulp_ok(ln, ln_p), f"layernorm_np disagrees with its plain version at {what}")
        check(bf16_ulp_ok(rn, rn_p), f"rmsnorm disagrees with its plain version at {what}")
        check(torch.equal(ln, layernorm_np(x, 1e-5)) and torch.equal(rn, rmsnorm(x, gamma, 1e-6)),
              f"the norms differ between two launches at {what}")
        return err_ln, err_rn

    timed = {}
    for rows in (SLOTS, SLOTS * PROMPT, TRAIN_BATCH * TRAIN_SEQ):
        x = (torch.randn((rows, d), generator=gen, device=DEVICE) * 3 + 1).to(torch.bfloat16)
        gamma = (torch.rand((d,), generator=gen, device=DEVICE) + 0.5).to(torch.bfloat16)
        err_ln, err_rn = agree(x, gamma, f"({rows}, {d}) bf16")
        nbytes = 2 * x.numel() * 2
        mma = x.numel() * 16  # m16n8k16 ones-MMA: 16 flops per element per statistic
        b_ln, by_ln = bound_ms(nbytes, tensor_flops=2 * mma, core_flops=6 * x.numel())
        b_rn, by_rn = bound_ms(nbytes + d * 2, tensor_flops=mma, core_flops=5 * x.numel())
        timed[rows] = {
            "layernorm_np": {
                "max_abs_err": err_ln,
                "ms": device_ms(lambda: layernorm_np(x, 1e-5), "row_norm_kernel"),
                "call_ms": time_ms(lambda: layernorm_np(x, 1e-5)),
                "plain_ms": device_ms(lambda: layernorm_np_plain(x, 1e-5)),
                "bound_ms": b_ln, "bound_by": by_ln,
                "library_ms": device_ms(lambda: F.layer_norm(x, (d,), eps=1e-5)),
                "norm_route": plan_for(x).name,
            },
            "rmsnorm": {
                "max_abs_err": err_rn,
                "ms": device_ms(lambda: rmsnorm(x, gamma, 1e-6), "row_norm_kernel"),
                "call_ms": time_ms(lambda: rmsnorm(x, gamma, 1e-6)),
                "plain_ms": device_ms(lambda: rmsnorm_plain(x, gamma, 1e-6)),
                "bound_ms": b_rn, "bound_by": by_rn,
                "library_ms": (device_ms(lambda: rms_lib(x, (d,), gamma, 1e-6))
                               if rms_lib is not None else None),
                "norm_route": plan_for(x, gamma).name,
            },
        }
        for name in ("layernorm_np", "rmsnorm"):
            t = timed[rows][name]
            lib = "-" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.2f}"
            print(f"{name} ({rows}, {d}) bf16: device {t['ms'] * 1e3:.2f} us, call "
                  f"{t['call_ms'] * 1e3:.2f} us, library {lib} us, "
                  f"bound {t['bound_ms'] * 1e3:.2f} us")
    for name in ("layernorm_np", "rmsnorm"):
        results[name] = dict(timed[TRAIN_BATCH * TRAIN_SEQ][name],
                             serving=timed[SLOTS * PROMPT][name], decode=timed[SLOTS][name])

    rows = TRAIN_BATCH * TRAIN_SEQ
    for dtype in (torch.float32, torch.float16):
        x = (torch.randn((rows, d), generator=gen, device=DEVICE) * 3 + 1).to(dtype)
        gamma = (torch.rand((d,), generator=gen, device=DEVICE) + 0.5).to(dtype)
        agree(x, gamma, f"({rows}, {d}) {str(dtype)[6:]}")
    buf = (torch.randn((1024 * d + 8,), generator=gen, device=DEVICE) * 3 + 1).to(torch.bfloat16)
    x = buf[1:1 + 1024 * d].view(1024, d)  # 2 bytes past a 16-byte boundary: read in place
    gamma = (torch.rand((d,), generator=gen, device=DEVICE) + 0.5).to(torch.bfloat16)
    check(x.data_ptr() % 16 == 2, "the offset view is not 2 bytes off")
    agree(x, gamma, f"(1024, {d}) bf16 at a 2-byte offset")
    for shape in ((1024, 2050), (64, 40000)):  # d % 16 != 0; a row longer than the registers
        x = (torch.randn(shape, generator=gen, device=DEVICE) * 3 + 1).to(torch.bfloat16)
        gamma = (torch.rand((shape[1],), generator=gen, device=DEVICE) + 0.5).to(torch.bfloat16)
        agree(x, gamma, f"{shape} bf16")
    check(plan_for(x).slabs > 1, "the (64, 40000) case did not take the re-read route")


def _causal_pairs(sq: int, skv: int, q_offset: int, window) -> int:
    """(query, key) pairs the masks leave visible."""
    n = 0
    for i in range(sq):
        qp = q_offset + i
        lo = 0 if window is None else max(0, qp - window + 1)
        n += max(0, min(qp, skv - 1) - lo + 1)
    return n


def check_attention(results: dict, gen) -> None:
    """K6 against its plain version; timed at the prefill shape (serving)
    and the training shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain

    cases = [  # b, hq, hkv, sq, skv, d, causal, window, q_offset
        (TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 128, True, None, 0),  # training (timed)
        (SLOTS, 16, 16, PROMPT, PROMPT, 128, True, None, 0),  # the prefill shape (timed)
        (1, 16, 4, 64, 320, 128, True, 128, 256),              # GQA + window + q_offset
        (2, 4, 2, 100, 100, 64, False, None, 0),               # ragged, non-causal
    ]
    timed = {}
    for case in reversed(cases):
        b, hq, hkv, sq, skv, d, causal, window, q_offset = case
        q = (torch.randn((b, hq, sq, d), generator=gen, device=DEVICE) * 0.5).to(torch.bfloat16)
        k = (torch.randn((b, hkv, skv, d), generator=gen, device=DEVICE) * 0.5).to(torch.bfloat16)
        v = (torch.randn((b, hkv, skv, d), generator=gen, device=DEVICE) * 0.5).to(torch.bfloat16)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out, plain = flash_attention(q, k, v, **kw), flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - plain.float()).abs().max())
        print(f"K6 flash_attention {case}: max_abs_err {err:.3g} vs plain "
              "(tol: 2 bf16 ulps of the output -- the same 128-key blocks, f32 sums in "
              "another order, which can flip one bf16 rounding of p)")
        check(bool(torch.isfinite(out.float()).all()), f"flash_attention non-finite at {case}")
        check(bool(torch.all((out.float() - plain.float()).abs()
                             <= 2.0**-6 * plain.float().abs() + 2e-3)),
              f"flash_attention disagrees with its plain version at {case}")
        if case not in cases[:2]:
            continue
        pairs = _causal_pairs(sq, skv, 0, None) * b * hq
        b_fa, by_fa = bound_ms(4 * q.numel() * 2, tensor_flops=4 * d * pairs, core_flops=pairs)
        timed[sq] = {
            "max_abs_err": err,
            "ms": device_ms(lambda: flash_attention(q, k, v, causal=True), "attn_fwd_kernel"),
            "call_ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
            "plain_ms": device_ms(lambda: flash_attention_plain(q, k, v, causal=True), iters=5),
            "bound_ms": b_fa, "bound_by": by_fa,
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                           is_causal=True)),
        }
    results["flash_attention"] = dict(timed[TRAIN_SEQ], serving=timed[PROMPT])


def check_parts(results: dict, gen) -> None:
    import torch

    from repro_torch.kernels import mma_sum_fused, mma_sum_parts
    from repro_torch.kernels.mma_reduce import mma_sum_parts_plain

    vocab = 50304
    chains = ((),)
    # NaN and Inf planted in two slots: the census must count them exactly
    bad = torch.randn((SLOTS, 1, vocab), generator=gen, device=DEVICE)
    bad[1, 0, 7] = float("nan")
    bad[2, 0, vocab - 1] = float("inf")
    bad[2, 0, 3] = float("-inf")
    row = mma_sum_parts([bad[i] for i in range(SLOTS)], prologue="square",
                        total_chains=chains, census=True)
    again = mma_sum_parts([bad[i] for i in range(SLOTS)], prologue="square",
                          total_chains=chains, census=True)
    check(torch.equal(row.nan_to_num(), again.nan_to_num()),
          "K4: a second launch folds differently (the fold ticket did not reset)")
    counts = row[SLOTS + 1:].tolist()
    print(f"K4 census with NaN/Inf planted: counts {counts}")
    check(counts == [0.0, 1.0, 2.0, 0.0, 3.0], f"K4 census counts wrong: {counts}")
    check(bool(torch.isnan(row[1])) and bool(torch.isinf(row[2])), "K4 poisoned slot sums")

    logits = torch.randn((SLOTS, 1, vocab), generator=gen, device=DEVICE) * 3
    parts = [logits[i] for i in range(SLOTS)]
    out = mma_sum_parts(parts, prologue="square", total_chains=chains, census=True)
    plain = mma_sum_parts_plain(parts, ("square",) * SLOTS, chains, True)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    mass = float(logits.square().sum())
    print(f"K4 mma_sum_parts {SLOTS} x {vocab} f32: max_abs_err {err:.3g} vs plain, "
          f"mass {mass:.4g} (tol: 1e-6 x mass -- f32 sums in another order; counts exact)")
    check(torch.equal(out[SLOTS + 1:], plain[SLOTS + 1:]), "K4 census differs from plain")
    check(err <= 1e-6 * mass, "mma_sum_parts disagrees with its plain version")
    b_k4, by_k4 = bound_ms(logits.numel() * 4 + out.numel() * 4,
                           core_flops=3 * logits.numel())

    def k4():
        return mma_sum_parts(parts, prologue="square", total_chains=chains, census=True)

    flat = logits.reshape(-1)
    serving = {
        "max_abs_err": err,
        "ms": device_ms(k4, "parts_kernel"),
        "call_ms": time_ms(k4),
        "plain_ms": device_ms(lambda: mma_sum_parts_plain(parts, ("square",) * SLOTS, chains,
                                                          True), iters=5),
        "bound_ms": b_k4, "bound_by": by_k4,
        "library_ms": device_ms(lambda: logits.square().sum(-1)),
        "stream_ms": device_ms(lambda: mma_sum_fused(flat, compute_dtype=torch.float32,
                                                     prologue="square", census=True)),
    }
    serving["fold_estimate_ms"] = serving["ms"] - serving["stream_ms"]
    print(f"K4 at the serving shape: {serving['ms'] * 1e3:.2f} us on the card; K1 over the same "
          f"{flat.numel()} f32 elements {serving['stream_ms'] * 1e3:.2f} us; fold_estimate_ms "
          f"{serving['fold_estimate_ms']:.5f}")
    results["mma_sum_parts"] = {"serving": serving}


def olmo_leaf_shapes(cfg) -> list:
    """Shapes of olmo's parameter leaves in ``reduce.tree_leaves`` order:
    the padded embedding, then per layer ffn down/gate/up and mix k/o/q/v."""
    from repro_torch.models.params import padded_vocab

    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.n_heads * cfg.d_head
    layer = [(f, d), (d, f), (d, f), (d, hd), (hd, d), (d, hd), (d, hd)]
    return [(padded_vocab(cfg.vocab_size), d)] + layer * cfg.n_layers


def check_parts_training(results: dict, gen) -> None:
    """K4 at the training path's size: the clip statistic over olmo-1b's
    113 f32 gradient leaves (1.18 B elements), with the optimizer's
    epilogue fork and the census. Also times the fused kernel (K1) over one
    buffer of the same elements, f32 compute and square prologue: the same
    bytes streamed with a 528-lane fold instead of K4's folds per part, so
    the difference (``fold_estimate_ms``) estimates what K4's folds add."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import mma_sum_fused, mma_sum_parts
    from repro_torch.kernels.mma_reduce import default_num_lanes, mma_sum_parts_plain

    leaves = [torch.randn(shape, generator=gen, device=DEVICE) * 1e-3
              for shape in olmo_leaf_shapes(get_arch("olmo-1b"))]
    total = sum(p.numel() for p in leaves)
    tiles = sum(-(-p.numel() // 16384) for p in leaves)
    chains = ((("sqrt",),), (("sqrt",), ("clip_coeff", 1.0, 1e-9)))
    pros = ("square",) * len(leaves)

    def k4():
        return mma_sum_parts(leaves, prologue="square", total_chains=chains, census=True)

    out, again = k4(), k4()
    plain = mma_sum_parts_plain(leaves, pros, chains, True)
    torch.cuda.synchronize()
    s = len(leaves)
    mass = float(plain[:s].sum())
    err = float((out[:s + 2] - plain[:s + 2]).abs().max())
    print(f"K4 mma_sum_parts, training shape: {s} f32 leaves, {total} elements, {tiles} tiles: "
          f"max_abs_err {err:.3g} vs plain at mass {mass:.4g} (tol: 1e-6 x mass -- f32 sums "
          f"in another order); gnorm {float(out[s]):.6g}, clip {float(out[s + 1]):.6g}")
    check(torch.equal(out, again), "K4 (training shape): a second launch folds differently")
    check(torch.equal(out[s + 2:], plain[s + 2:]) and float(out[-1]) == 0.0,
          "K4 (training shape): census differs from plain")
    check(err <= 1e-6 * mass, "K4 (training shape) disagrees with its plain version")
    b_k4, by_k4 = bound_ms(total * 4 + out.numel() * 4, core_flops=2 * total)
    lib = getattr(torch.nn.utils, "get_total_norm", None)
    # Each of these calls keeps the card busy for milliseconds, far longer
    # than its host work (~0.1 ms), so CUDA events around back-to-back calls
    # read device time; the profiler is kept off the plain version, whose
    # ~144 000 small kernels per call make it drop events.
    results["mma_sum_parts"].update({
        "max_abs_err": err,
        "ms": time_ms(k4, iters=5, warmup=1),
        "profiler_ms": device_ms(k4, "parts_kernel", iters=5, warmup=0),
        "plain_ms": time_ms(lambda: mma_sum_parts_plain(leaves, pros, chains, True),
                            iters=1, warmup=0),
        "bound_ms": b_k4, "bound_by": by_k4,
        "library_ms": time_ms(lambda: lib(leaves), iters=5, warmup=1) if lib is not None else None,
        "tiles": tiles,
    })
    results["mma_sum_parts"]["call_ms"] = results["mma_sum_parts"]["ms"]

    def k4_no_census():
        return mma_sum_parts(leaves, prologue="square", total_chains=chains)

    # the guarded step's census against the same launch without it, three
    # of each in turns (off, on, off, on, off, on)
    on, off = [], []
    for _ in range(3):
        off.append(time_ms(k4_no_census, iters=5, warmup=1))
        on.append(time_ms(k4, iters=5, warmup=1))
    results["mma_sum_parts"]["census_on_ms"] = sorted(on)[1]
    results["mma_sum_parts"]["census_off_ms"] = sorted(off)[1]
    print(f"K4 at the training shape, census on {on} ms, off {off} ms (CUDA events, in turns): "
          f"the census costs {(sorted(on)[1] / sorted(off)[1] - 1) * 100:+.2f}% (medians)")
    flat = torch.cat([p.reshape(-1) for p in leaves])
    del leaves
    lanes = default_num_lanes(flat)
    stream_ms = time_ms(lambda: mma_sum_fused(flat, compute_dtype=torch.float32,
                                              prologue="square", num_lanes=lanes),
                        iters=5, warmup=1)
    fold = results["mma_sum_parts"]["ms"] - stream_ms
    results["mma_sum_parts"]["fold_estimate_ms"] = fold
    print(f"K4 at the training shape: {results['mma_sum_parts']['ms']:.4f} ms on the card "
          f"(CUDA events; the profiler reads {results['mma_sum_parts']['profiler_ms']:.4f} ms); "
          f"K1 over the same {total} f32 elements ({lanes} lanes): {stream_ms:.4f} ms; "
          f"the difference, fold_estimate_ms {fold:.4f}, estimates what K4's folds of "
          f"{tiles} tile partials add")
    del flat
    torch.cuda.empty_cache()


def check_cross_entropy(results: dict, gen) -> None:
    """K7 against its plain version: the training path's (2048, 50432) f32
    padded logits (pad logits at -1e30, as the chunked loss's head gives
    them), the same logits cut to the 50304 real columns (the serving
    head's width: the same loss), a ragged odd width (the element route),
    one row, a vocabulary under one slice, bf16 logits at 256 rows and at
    the training shape; one launch a call, a repeat bitwise."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cross_entropy
    from repro_torch.kernels.cross_entropy import cross_entropy_plain

    rows, width, vocab = TRAIN_BATCH * TRAIN_SEQ, 50432, 50304
    print("K7's fold: 2048-column slices (one CTA each per 16-row block), 4 KB warp steps dealt "
          "to 4 warps in turn, each warp's running max over its steps; warps merged in warp "
          "order, slices in slice order (csrc/cross_entropy.cu, ops.cross_entropy_plain)")
    cases = [(300, 1001, torch.float32), (1, vocab, torch.float32), (20, 1000, torch.float32),
             (256, vocab, torch.bfloat16), (rows, width, torch.bfloat16),
             (rows, width, torch.float32)]  # the last: the training path (timed)
    for r, w, dtype in cases:
        logits = torch.randn((r, w), generator=gen, device=DEVICE) * 3
        logits[:, vocab:] = -1e30
        logits = logits.to(dtype)
        labels = torch.randint(0, min(w, vocab), (r,), generator=gen, device=DEVICE)
        before = cross_entropy.launches
        out = cross_entropy(logits, labels)
        check(cross_entropy.launches == before + 1, f"cross_entropy at {(r, w)}: launches")
        plain = cross_entropy_plain(logits, labels)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        print(f"K7 cross_entropy ({r}, {w}) {str(dtype)[6:]}: max_abs_err {err:.3g} vs plain "
              "(tol 1e-3: the same slices, steps and running maxima; the kernel's ex2.approx "
              "and torch.exp may differ by an ulp or two and flip one bf16 rounding of p, "
              "moving l by up to 2^-9 of that p)")
        check(bool(torch.isfinite(out).all()), "cross_entropy non-finite")
        check(err <= 1e-3, f"cross_entropy disagrees with its plain version at {(r, w)}")
        check(torch.equal(out, cross_entropy(logits, labels)),
              f"cross_entropy at {(r, w)}: a repeat differs")
    cut = cross_entropy(logits[:, :vocab].contiguous(), labels)
    d_cut = float((cut - out).abs().max())
    print(f"K7 the same logits cut to their {vocab} real columns: max |d| {d_cut:.3g} "
          "(tol 1e-6: pad logits at -1e30 add exactly 0)")
    check(d_cut <= 1e-6, "cross_entropy: padded and cut widths differ")
    n = rows * width
    b_ce, by_ce = bound_ms(n * 4 + rows * 8, tensor_flops=16 * n, core_flops=4 * n)
    lab64 = labels.to(torch.int64)
    results["cross_entropy"] = {
        "max_abs_err": err,
        "ms": device_ms(lambda: cross_entropy(logits, labels), "::ce_kernel<"),
        "call_ms": time_ms(lambda: cross_entropy(logits, labels), iters=20),
        "plain_ms": device_ms(lambda: cross_entropy_plain(logits, labels), iters=3),
        "bound_ms": b_ce, "bound_by": by_ce,
        "library_ms": device_ms(lambda: F.cross_entropy(logits, lab64, reduction="none")),
    }


def fused_tol(n: int, lanes: int, mass: float) -> float:
    """One f32 ulp of the running sum per accumulation step, n / (lanes x
    256) steps per thread (tensor cores may truncate their f32
    accumulation), times the mass."""
    from repro_torch.kernels.mma_reduce import lane_geometry

    c = lane_geometry(n, lanes)[1]
    return max(1.0, n / (c * 256)) * 2.0**-23 * mass + 1e-6


def check_fused_sum(results: dict, gen) -> None:
    """K1 against its plain version: the training path's token sum ((4,
    512) f32 per-token losses at bf16 compute), 2^26 bf16 elements (where
    bytes matter), the census on planted NaN/Inf, an epilogue chain, and a
    bitwise repeat of every launch."""
    import torch

    from repro_torch.kernels import mma_sum_fused
    from repro_torch.kernels.mma_reduce import default_num_lanes, mma_sum_fused_plain

    def compare(x, what, **kw):
        lanes = kw.setdefault("num_lanes", default_num_lanes(x))
        got, again, want = mma_sum_fused(x, **kw), mma_sum_fused(x, **kw), mma_sum_fused_plain(x, **kw)
        got_t, want_t = (got[0], want[0]) if kw.get("census") else (got, want)
        torch.cuda.synchronize()
        xf = x.float().nan_to_num(0.0, 0.0, 0.0)
        mass = float((xf * xf if kw.get("prologue") == "square" else xf.abs()).sum())
        err = abs(float(got_t) - float(want_t))
        print(f"K1 mma_sum_fused {what}: {float(got_t):.9g} vs plain {float(want_t):.9g}, "
              f"max_abs_err {err:.3g} at mass {mass:.4g} (tol {fused_tol(x.numel(), lanes, mass):.3g}"
              ": one f32 ulp of the running sum per accumulation step); repeat bitwise")
        same = all(torch.equal(a, b) for a, b in zip(got, again)) if kw.get("census") else (
            torch.equal(got, again))
        check(same, f"K1 {what}: a second launch differs")
        check(err <= fused_tol(x.numel(), lanes, mass), f"K1 {what} disagrees with its plain version")
        return got, want

    path = torch.rand((TRAIN_BATCH, TRAIN_SEQ), generator=gen, device=DEVICE) * 4 + 9
    compare(path, f"({TRAIN_BATCH}, {TRAIN_SEQ}) f32 at bf16 compute (the token sum)")
    # A non-zero mean: a lost lane block (131072 elements) or a lost warp's
    # share then moves the sum by far more than the tolerance.
    big = (torch.randn((2**26,), generator=gen, device=DEVICE) * 2 + 0.3).to(torch.bfloat16)
    compare(big, "2^26 bf16 at bf16 compute")
    compare(big, "2^26 bf16, abs at bf16 compute", prologue="abs")
    compare(big, "2^26 bf16, square at f32 compute, epilogue sqrt+clip", prologue="square",
            compute_dtype=torch.float32, epilogue=(("sqrt",), ("clip_coeff", 1.0, 1e-9)))
    bad = torch.randn((5 * 131072 + 3,), generator=gen, device=DEVICE)
    bad[7], bad[131072], bad[-1] = float("nan"), float("inf"), float("-inf")
    (tot, cnt), (_, pcnt) = compare(bad.nan_to_num(0.0, 0.0, 0.0), "census, clean", census=True)
    check(float(cnt) == float(pcnt) == 0.0, "K1 census counts a clean input")
    (tot, cnt), (_, pcnt) = (mma_sum_fused(bad, census=True, num_lanes=4),
                             mma_sum_fused_plain(bad, census=True, num_lanes=4))
    print(f"K1 census with NaN/Inf planted: count {float(cnt)}, plain {float(pcnt)}, "
          f"total {float(tot)}")
    check(float(cnt) == float(pcnt) == 3.0 and not bool(torch.isfinite(tot)),
          "K1 census counts wrong")
    # The one-lane route (one CTA writes [chain(0 + total), count], no
    # ticket): integer values sum exactly in any order, so the kernel is its
    # plain version bitwise at every compute dtype; -0.0 values sum to +0.0.
    chain = (("scale", 0.5), ("add_eps", 3.0))
    for n in (1, 7, 2048, 131072, 131073):
        ints = torch.randint(-8, 9, (n,), generator=gen, device=DEVICE).to(torch.float32)
        if n > 2:
            ints[n // 2] = float("nan")
        zeros = torch.full((n,), -0.0, device=DEVICE)
        for what, x, kw in (("integers, census and chain", ints, dict(census=True, epilogue=chain)),
                            ("-0.0 values", zeros, dict(census=True)),
                            ("bf16 integers, square", ints.nan_to_num(0.0).to(torch.bfloat16),
                             dict(prologue="square"))):
            for cd in (torch.float32, torch.bfloat16):
                got = mma_sum_fused(x, compute_dtype=cd, num_lanes=1, **kw)
                want = mma_sum_fused_plain(x, compute_dtype=cd, num_lanes=1, **kw)
                got, want = (torch.stack(list(v)) if kw.get("census") else v.reshape(1)
                             for v in (got, want))
                real = ~want.isnan()
                check(torch.equal(got.nan_to_num(), want.nan_to_num())
                      and torch.equal(got.isnan(), want.isnan())
                      and torch.equal(got[real].signbit(), want[real].signbit()),
                      f"K1 one-lane route, n = {n}, {what} at {cd}: {got.tolist()} vs plain "
                      f"{want.tolist()}")
    print("K1 one-lane route (n = 1, 7, 2048, 131072, 131073 in one lane; census, chain, "
          "square, a -0.0 total): bitwise its plain version at f32 and bf16 compute")
    buf = (torch.randn((2**20 + 11,), generator=gen, device=DEVICE) * 2 + 0.3).to(torch.bfloat16)
    compare(buf[1:2**20 + 4], "2^20 + 3 bf16, one element off 16-byte alignment")

    def timings(x):
        lanes = default_num_lanes(x)
        nbytes = x.numel() * x.element_size() + 8
        b, by = bound_ms(nbytes, tensor_flops=16 * x.numel(), core_flops=2 * x.numel())
        return {
            "ms": device_ms(lambda: mma_sum_fused(x, num_lanes=lanes), "fused_sum_kernel"),
            "call_ms": time_ms(lambda: mma_sum_fused(x, num_lanes=lanes)),
            "plain_ms": device_ms(lambda: mma_sum_fused_plain(x, num_lanes=lanes), iters=5),
            "bound_ms": b, "bound_by": by,
            "library_ms": device_ms(lambda: torch.sum(x, dtype=torch.float32)),
        }

    results["mma_sum_fused"] = dict(
        timings(path),
        max_abs_err=abs(float(mma_sum_fused(path)) - float(mma_sum_fused_plain(path))),
        at_2e26_bf16=timings(big),
    )


# ------------------------- the paper's reduction (K10, K2, K3) -----------------------

_UNIT = {"torch.float32": 2.0**-24, "torch.bfloat16": 2.0**-8, "torch.float16": 2.0**-11}


def _unit(dtype) -> float:
    """Unit roundoff of a compute dtype."""
    return _UNIT[str(dtype)]


def _mapped(x, compute, prologue):
    """x cast to the compute dtype and mapped by the prologue there, as f32
    (the squares of "moments")."""
    from repro_torch.kernels.mma_reduce.ops import _map, _round

    return _map(_round(x.float(), compute), "square" if prologue == "moments" else prologue,
                compute)


def _tile_tol(v, compute):
    """Per tile of a K10 level over the mapped values ``v``: two ulps of the
    tile's largest row sum at the compute dtype (a row summed in another
    order may round the other way before the second MMA; f32 sums on the
    card and in torch take other orders) plus f32 noise of its mass."""
    import torch

    t = -(-v.numel() // 16384)
    rows = torch.nn.functional.pad(v, (0, t * 16384 - v.numel())).view(t, 128, 128)
    rows = rows.sum(-1).abs()
    return 4 * _unit(compute) * rows.amax(-1) + 2.0**-16 * rows.sum(-1) + 1e-6


def plain_hierarchy(x, compute, prologue="identity", chain=()):
    """The hierarchy with every level's plain version, on the card."""
    from repro_torch.kernels.mma_reduce import tile_partials_plain

    v, pro = x, prologue
    while v.numel() > 1:
        t = -(-v.numel() // 16384)
        v = tile_partials_plain(v, compute, pro, chain if t == 1 else ())[:t]
        pro = "identity"
    return (_mapped(v, compute, pro) if pro != "identity" else v).reshape(())


def hierarchy_tol(x, compute, prologue="identity") -> float:
    """The levels' tile tolerances (``_tile_tol``) summed along the plain
    hierarchy."""
    from repro_torch.kernels.mma_reduce import tile_partials_plain

    v, pro, tol = x, prologue, 0.0
    while v.numel() > 1:
        tol += float(_tile_tol(_mapped(v, compute, pro), compute).sum())
        v = tile_partials_plain(v, compute, pro)[:-(-v.numel() // 16384)]
        pro = "identity"
    return tol


def check_tile_partials(results: dict, gen) -> None:
    """K10 against its plain version on the card: level 0 tile by tile, then
    the whole hierarchy (two launches at 2^28) against the plain hierarchy
    and the f64 sum, with its launch count and the bytes at the launch
    boundary held against the cost model. The main path's f32 2^28, bf16
    2^28, 2^28 - 4097 (the tail mask), 2^26 + 5 bf16 two bytes off its
    base (element loads, ragged tail), f16 once, the square, abs and
    moments prologues, and an epilogue chain on the final level."""
    import torch

    from repro_torch.core import cost_model
    from repro_torch.kernels import common
    from repro_torch.kernels.mma_reduce import (mma_moments_hier, mma_sum_hier, tile_partials,
                                                tile_partials_plain)

    base = torch.randn((PAPER_N,), generator=gen, device=DEVICE) * 2 + 0.3
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # what, x, compute, prologue, chain
        ("2^28 f32 at bf16 compute (the demo's sum)", base, bf, "identity", ()),
        ("2^28 f32 at f32 compute", base, f32, "identity", ()),
        ("2^28 bf16", base.to(bf), bf, "identity", ()),
        ("2^28 - 4097 bf16 (tail mask)", base[:PAPER_N - 4097].to(bf), bf, "identity", ()),
        # a view 2 bytes past an aligned base (element loads) with a ragged tail
        ("2^26 + 5 bf16, 2 bytes off the base", base[:2**26 + 6].to(bf)[1:], bf, "identity",
         ()),
        # zero mean: f16 partials of a 0.3 mean overflow at level 1 (rows of
        # 128 partials of ~4900), the reference's semantics too
        ("2^26 f16, mean 0", (base[:2**26] - 0.3).to(torch.float16), torch.float16, "identity",
         ()),
        ("2^28 bf16, square", base.to(bf), bf, "square", ()),
        ("2^28 bf16, abs", base.to(bf), bf, "abs", ()),
        ("2^28 f32, square at f32, chain sqrt+clip", base, f32, "square",
         (("sqrt",), ("clip_coeff", 1.0, 1e-9))),
    ]
    for what, x, cd, pro, chain in cases:
        n = x.numel()
        level0 = tile_partials(x, compute_dtype=cd, prologue=pro)
        want0 = tile_partials_plain(x, cd, pro)[:level0.numel()]
        err0 = float((level0 - want0).abs().max())
        check(bool(torch.all((level0 - want0).abs() <= _tile_tol(_mapped(x, cd, pro), cd))),
              f"K10 level 0 ({what}) disagrees with its plain version")
        before, tr = tile_partials.launches, []
        total = float(mma_sum_hier(x, compute_dtype=cd, prologue=pro, epilogue=chain, trace=tr))
        launched = tile_partials.launches - before
        raw, tol = float(plain_hierarchy(x, cd, pro)), hierarchy_tol(x, cd, pro)
        exact = float(_mapped(x, f32, pro).double().sum())
        mass = float(_mapped(x, f32, "abs" if pro == "identity" else pro).double().sum())
        tol_f64 = max(2 * _unit(cd), 2.0**-17) * mass + 1e-6
        want = raw
        if chain:  # the chain of the total: its relative errors carry over
            def fin(v):
                return float(common.apply_epilogue(torch.tensor(v, dtype=torch.float64), chain))

            want, exact_c = fin(raw), fin(exact)
            tol, tol_f64 = abs(want) * tol / abs(raw), abs(exact_c) * tol_f64 / abs(exact)
            exact = exact_c
        model = cost_model.hier_hbm_bytes(n, x.element_size())
        print(f"K10 tile_partials {what}: level 0 max_abs_err {err0:.3g} vs plain (tol: 2 ulps of "
              f"each tile's largest row sum at the compute dtype); hierarchy {total:.9g} vs plain "
              f"{want:.9g} (|d| {abs(total - want):.3g}, tol {tol:.3g}: the levels' tile "
              f"tolerances summed), vs f64 {exact:.9g} (|d| {abs(total - exact):.3g}, tol "
              f"{tol_f64:.3g}: two compute-dtype roundings of the mass); {launched} launches, "
              f"{tr[0].launch_io_bytes} bytes at the launches (cost model "
              f"{cost_model.levels(n, 128)}, {model.launch_io})")
        check(abs(total - want) <= tol, f"K10 hierarchy ({what}) disagrees with its plain version")
        check(abs(total - exact) <= tol_f64, f"K10 hierarchy ({what}) is off the f64 sum")
        check(launched == cost_model.levels(n, 128) == tr[0].levels,
              f"K10 ({what}): {launched} launches, cost model {cost_model.levels(n, 128)}")
        check(tr[0].launch_io_bytes == model.launch_io,
              f"K10 ({what}): {tr[0].launch_io_bytes} bytes at the launches, model {model.launch_io}")
    # the moments prologue: a (t, 2) level 0, then one hierarchy per column
    x = base.to(bf)
    pair = tile_partials(x, compute_dtype=bf, prologue="moments")
    want = tile_partials_plain(x, bf, "moments")[:pair.shape[0]]
    check(bool(torch.all((pair[:, 0] - want[:, 0]).abs() <= _tile_tol(_mapped(x, bf, "abs"), bf)))
          and bool(torch.all((pair[:, 1] - want[:, 1]).abs() <= _tile_tol(_mapped(x, bf, "square"),
                                                                          bf))),
          "K10 moments level 0 disagrees with its plain version")
    before, tr = tile_partials.launches, []
    s, ss = mma_moments_hier(x, trace=tr)
    t0 = -(-PAPER_N // 16384)
    check(tile_partials.launches - before == 1 + 2 * cost_model.levels(t0, 128),
          "K10 moments: launch count")
    check(tr[0].launch_io_bytes == cost_model.hier_moments_hbm_bytes(PAPER_N, 2).launch_io,
          "K10 moments: bytes at the launches differ from the cost model")
    ps, pss = float(plain_hierarchy(x, bf)), float(plain_hierarchy(x, bf, "square"))
    print(f"K10 moments 2^28 bf16: ({float(s):.9g}, {float(ss):.9g}) vs plain ({ps:.9g}, "
          f"{pss:.9g}); {tr[0].levels} launches, bytes as the cost model")
    check(abs(float(s) - ps) <= hierarchy_tol(x, bf)
          and abs(float(ss) - pss) <= hierarchy_tol(x, bf, "square"),
          "K10 moments hierarchy disagrees with its plain version")

    def timings(x):
        n = x.numel()
        b, by = bound_ms(n * x.element_size() + 4, tensor_flops=16 * n)
        return {
            "ms": device_ms(lambda: mma_sum_hier(x), "::tile_partials_kernel<"),
            "call_ms": time_ms(lambda: mma_sum_hier(x), iters=20),
            "plain_ms": device_ms(lambda: plain_hierarchy(x, bf), iters=3),
            "bound_ms": b, "bound_by": by,
            "library_ms": device_ms(lambda: torch.sum(x, dtype=torch.float32)),
        }

    results["tile_partials"] = dict(
        timings(base), max_abs_err=abs(float(mma_sum_hier(base)) - float(plain_hierarchy(base, bf))),
        at_2e28_bf16=timings(base.to(bf)))


def check_moments_and_kahan(results: dict, gen) -> None:
    """K2 and K3 at 2^28 (the demo's f32, and bf16) against their plain
    versions and the f64 sums, repeat launches bitwise; then Kahan against
    native where the carry dominates: 2^24 f32 at one lane and at the
    default lanes."""
    import torch

    from repro_torch.core.precision import ulps
    from repro_torch.kernels.mma_reduce import (default_num_lanes, lane_geometry,
                                                mma_moments_fused, mma_moments_fused_plain,
                                                mma_sum_fused, mma_sum_kahan,
                                                mma_sum_kahan_plain)

    base = torch.randn((PAPER_N,), generator=gen, device=DEVICE) * 2 + 0.3
    bf = torch.bfloat16
    print("K3's fold: each lane's CTA runs one Kahan pass over its acc rows 0..127, then its "
          "negated comp rows, giving (s_c, c_c); the last CTA runs one over s_0, -c_0, s_1, "
          "-c_1, ... in lane order (ops.combine_lane_pairs_kahan)")
    for what, x in (("2^28 f32 at bf16 compute", base), ("2^28 bf16", base.to(bf)),
                    ("2^28 - 4097 bf16", base[:PAPER_N - 4097].to(bf))):
        lanes = default_num_lanes(x)
        (s, ss), (s2, ss2) = mma_moments_fused(x, num_lanes=lanes), mma_moments_fused(
            x, num_lanes=lanes)
        ps, pss = mma_moments_fused_plain(x, bf, lanes)
        xc = x.to(bf).double()
        ts = fused_tol(x.numel(), lanes, float(xc.abs().sum()))
        tss = fused_tol(x.numel(), lanes, float((x.float() ** 2).sum()))
        es, ess = float(xc.sum()), float((xc * xc).sum())
        print(f"K2 mma_moments_fused {what}: ({float(s):.9g}, {float(ss):.9g}) vs plain "
              f"|d| ({abs(float(s) - float(ps)):.3g}, {abs(float(ss) - float(pss)):.3g}) (tol "
              f"({ts:.3g}, {tss:.3g}): one f32 ulp of the running sum per accumulation step); "
              f"vs f64 of the bf16 values and their bf16 squares |d| ({abs(float(s) - es):.3g}, "
              f"{abs(float(ss) - ess):.3g}); repeat bitwise")
        check(torch.equal(s, s2) and torch.equal(ss, ss2), f"K2 {what}: a second launch differs")
        check(abs(float(s) - float(ps)) <= ts and abs(float(ss) - float(pss)) <= tss,
              f"K2 {what} disagrees with its plain version")
        check(abs(float(s) - es) <= ts + 1e-6 * float(xc.abs().sum())
              and abs(float(ss) - ess) <= tss + 2 * _unit(bf) * float((xc * xc).sum()),
              f"K2 {what} is off the f64 sums")
        k, k2 = mma_sum_kahan(x, num_lanes=lanes), mma_sum_kahan(x, num_lanes=lanes)
        kp = mma_sum_kahan_plain(x, bf, "identity", (), lanes)
        mass = float(xc.abs().sum())
        print(f"K3 mma_sum_kahan {what}: {float(k):.9g} vs plain {float(kp):.9g} (|d| "
              f"{abs(float(k) - float(kp)):.3g}, tol {2.0**-20 * mass:.3g}: the same row sums up "
              f"to their order, carried and folded by the same steps), vs f64 of the bf16 values "
              f"|d| {abs(float(k) - es):.3g}; repeat bitwise")
        check(torch.equal(k, k2), f"K3 {what}: a second launch differs")
        check(abs(float(k) - float(kp)) <= 2.0**-20 * mass, f"K3 {what} disagrees with plain")
        check(abs(float(k) - es) <= 2.0**-20 * mass + 1e-3, f"K3 {what} is off the f64 sum")

    # 1024 tiles: f32 compute, so only the carry differs; at one lane
    # native's running sums drop the noise's low bits
    for what, x, gate in (
            ("1 + U[0, 1e-3) (one-sided noise)", 1.0 + torch.rand(
                (2**24,), generator=gen, device=DEVICE) * 1e-3, True),
            ("1 + N(0, 1e-3) (symmetric noise)", 1.0 + torch.randn(
                (2**24,), generator=gen, device=DEVICE) * 1e-3, False)):
        exact = float(x.double().sum())
        for lanes in (1, default_num_lanes(x)):
            native = float(mma_sum_fused(x, compute_dtype=torch.float32, num_lanes=lanes))
            kahan = float(mma_sum_kahan(x, compute_dtype=torch.float32, num_lanes=lanes))
            lanes = lane_geometry(x.numel(), lanes)[1]  # the lanes launched
            print(f"Kahan where the carry dominates, 2^24 f32 {what}, {lanes} lanes, f32 "
                  f"compute: native off the f64 sum by {abs(native - exact):.4g} "
                  f"({ulps(native, exact):.1f} ulps of the total), kahan by "
                  f"{abs(kahan - exact):.4g} ({ulps(kahan, exact):.1f} ulps)")
            if gate:
                check(lanes > 1 or ulps(native, exact) >= 10,
                      "the carry-dominated input does not stress native")
                check(abs(kahan - exact) <= abs(native - exact),
                      f"Kahan is less accurate than native at {lanes} lanes")

    def timings(x, fn, plain, kernel, library, nearest=None):
        n = x.numel()
        b, by = bound_ms(n * x.element_size() + 8, tensor_flops=16 * n)
        t = {"ms": device_ms(fn, kernel), "call_ms": time_ms(fn, iters=20),
             "plain_ms": device_ms(plain, iters=3), "bound_ms": b, "bound_by": by,
             "library_ms": device_ms(library) if library is not None else None}
        if nearest is not None:  # no call gives (sum, sumsq); var_mean reads x once for both
            t["var_mean_ms"] = device_ms(nearest)
        return t

    lanes = default_num_lanes(base)
    xb = base.to(bf)
    results["mma_moments_fused"] = dict(
        timings(base, lambda: mma_moments_fused(base, num_lanes=lanes),
                lambda: mma_moments_fused_plain(base, bf, lanes), "::fused_sum_kernel<", None,
                lambda: torch.var_mean(base, correction=0)),
        max_abs_err=abs(float(mma_moments_fused(base, num_lanes=lanes)[0])
                        - float(mma_moments_fused_plain(base, bf, lanes)[0])),
        at_2e28_bf16=timings(xb, lambda: mma_moments_fused(xb, num_lanes=lanes),
                             lambda: mma_moments_fused_plain(xb, bf, lanes),
                             "::fused_sum_kernel<", None,
                             lambda: torch.var_mean(xb, correction=0)))
    results["mma_sum_kahan"] = dict(
        timings(base, lambda: mma_sum_kahan(base, num_lanes=lanes),
                lambda: mma_sum_kahan_plain(base, bf, "identity", (), lanes),
                "::fused_kahan_kernel<", lambda: torch.sum(base, dtype=torch.float32)),
        max_abs_err=abs(float(mma_sum_kahan(base, num_lanes=lanes))
                        - float(mma_sum_kahan_plain(base, bf, "identity", (), lanes))),
        at_2e28_bf16=timings(xb, lambda: mma_sum_kahan(xb, num_lanes=lanes),
                             lambda: mma_sum_kahan_plain(xb, bf, "identity", (), lanes),
                             "::fused_kahan_kernel<", lambda: torch.sum(xb, dtype=torch.float32)),
        # one CTA streams the whole input (the route of n <= one block)
        one_lane_ms={what: device_ms(lambda v=v: mma_sum_kahan(v, num_lanes=1),
                                     "::fused_kahan_kernel<", iters=3, warmup=1)
                     for what, v in (("2^28 f32", base), ("2^28 bf16", xb))})
    print(f"K3 at one lane, device ms: {results['mma_sum_kahan']['one_lane_ms']}")


def check_reduce_against_cpu(gen) -> None:
    """``reduce`` on the card against the same call on the CPU (the kernels'
    plain versions) at 2^20, every kind, backend and precision. Tolerance:
    the compute dtype's unit roundoff times the mass / 64 (a row sum may
    round the other way; lanes fold in other orders), f32 noise at f32
    compute."""
    import torch

    from repro_torch import reduce as R

    x = torch.randn((2**20,), generator=gen, device=DEVICE) * 2 + 0.3
    xc = x.cpu()
    worst = 0.0
    for backend in R.available_backends():
        for kind in ("sum", "mean", "sumsq", "norm2", "moments"):
            for prec in ("native", "kahan"):
                # "segmented" picks its executor by device: at native
                # precision, hold the card's pick against the same
                # executor's plain versions on the CPU; under "kahan" it
                # runs the blocked combine over torch-math block sums on
                # either device, so against itself
                cpu_backend = (R.segmented_backend_for(x.numel(), x.dtype, 128, x.device)
                               if backend == "segmented" and prec == "native" else backend)
                got = R.reduce(x, kind=kind, backend=backend, precision=prec)
                want = R.reduce(xc, kind=kind, backend=cpu_backend, precision=prec)
                cd = R.plan_for(x.shape, x.dtype, kind=kind, backend=backend).compute_torch
                pairs = zip(got, want, ("sum", "sumsq")) if kind == "moments" else [
                    (got, want, kind)]
                for g, w, k in pairs:
                    v = xc.double() ** 2 if k in ("sumsq", "norm2") else xc.double().abs()
                    tol = max(_unit(cd) / 64, 2.0**-20) * float(v.sum())
                    if k == "mean":
                        tol /= x.numel()
                    if k == "norm2":
                        tol /= 2 * float(w)
                    err = abs(float(g) - float(w))
                    worst = max(worst, err / tol)
                    check(g.device.type == "cuda" and err <= tol,
                          f"reduce({kind}, {backend}, {prec}): card {float(g)} vs CPU {float(w)}")
    print(f"reduce card vs CPU, 2^20 f32, {len(R.available_backends())} backends x 5 kinds x "
          f"2 precisions: all within tolerance (worst |d| / tol {worst:.3g})")


def check_auto_route(gen) -> None:
    """``reduce(x)`` with no backend named, at 2^28 f32 on the card: the
    planner takes the operand's device and sends a full reduction this long
    to ``cuda_fused``, ONE launch of K1 and no other kernel. Tolerance: one
    bf16 unit roundoff (the auto plan's compute dtype) times the mass,
    against the f64 sum. An f64 operand of 2 m^2 elements, which the
    kernels cannot read, stays on ``mma_torch`` and launches none (within
    n f64 unit roundoffs times the mass)."""
    import torch

    from repro_torch import reduce as R

    x = torch.randn((PAPER_N,), generator=gen, device=DEVICE) + 0.5
    plan = R.plan_for(x.shape, x.dtype, device=x.device)
    got, launches = counted_run(lambda: R.reduce(x))
    launches = {k: v for k, v in launches.items() if v}
    exact = float(x.double().sum())
    err = abs(float(got) - exact)
    print(f"reduce(x) on auto, 2^28 f32 on the card: plan backend {plan.backend}, launches "
          f"{launches}, |d| vs f64 {err:.4g} (sum {exact:.6g})")
    check(plan.backend == "cuda_fused" and launches == {"mma_sum_fused": 1},
          f"auto reduce at 2^28 on the card did not take one cuda_fused launch: {launches}")
    check(err <= 2.0**-8 * float(x.double().abs().sum()), "auto reduce at 2^28: off the f64 sum")
    x64 = x[:2 * 128 * 128].double()
    plan64 = R.plan_for(x64.shape, x64.dtype, device=x64.device)
    got64, launches64 = counted_run(lambda: R.reduce(x64))
    launches64 = {k: v for k, v in launches64.items() if v}
    err64 = abs(float(got64) - float(x64.sum()))
    print(f"reduce(x) on auto, 2*128^2 f64 on the card: plan backend {plan64.backend}, "
          f"launches {launches64}, |d| vs torch.sum {err64:.4g}")
    check(plan64.backend == "mma_torch" and not launches64 and got64.dtype == torch.float64,
          f"auto reduce of f64 on the card: {plan64.backend}, {launches64}")
    check(err64 <= x64.numel() * 2.0**-53 * float(x64.abs().sum()),
          "auto reduce of f64 on the card: off torch.sum")


# -------------------- the multi-reduce and scan path (K8, K9, K4) --------------------

MULTI_N = 2**28  # the packed buffer and the scans: 1.07 GB of f32
SEGMENTS = 2048


def _segment_mass(x, offsets, square=False):
    """(S,) f64 sums of |x| (or x^2) per segment, on the card."""
    import torch
    import numpy as np

    lengths = torch.from_numpy(np.diff(offsets)).to(x.device)
    ids = torch.repeat_interleave(torch.arange(lengths.numel(), device=x.device), lengths)
    v = x.double()
    v = v * v if square else v.abs()
    return torch.zeros(lengths.numel(), dtype=torch.float64, device=x.device).index_add_(
        0, ids, v.nan_to_num(0.0, 0.0, 0.0))


def check_segments(results: dict, gen) -> None:
    """K8 at 2^28 in 2048 packed ragged segments (the demo's offsets: two
    empty in the middle, boundaries off the tile grid) against its plain
    version: f32 and bf16 input, the default lanes and 1 lane, the square
    prologue at f32 compute (bitwise: the same adds in the same order),
    moments, the census on planted NaN/Inf, an epilogue chain; one launch
    per call, and the launch-boundary bytes against
    ``cost_model.segmented_hbm_bytes``. Tolerance at bf16 compute: 2^-16 of
    each segment's mass -- the same element roundings, summed in f32 in
    another order on the tensor cores (a lost row or tile would move a
    segment by 2^-10 of its mass or more); counts exact."""
    import numpy as np
    import torch

    from repro_torch.core import cost_model
    from repro_torch.kernels.mma_reduce import default_num_lanes, ops
    from repro_torch.launch.reduce_demo import packed_offsets

    offsets = packed_offsets(MULTI_N, SEGMENTS, 0)
    nseg = SEGMENTS
    cover_src = ops.segment_cover_layout(offsets, ops.TILE)[1]
    fetched = ops._cover_fetched_elems(cover_src, MULTI_N, ops.TILE)
    x = torch.randn((MULTI_N,), generator=gen, device=DEVICE) * 2 + 0.3
    lanes = default_num_lanes(x)
    bf, f32 = torch.bfloat16, torch.float32
    mass = _segment_mass(x, offsets)
    mass_sq = _segment_mass(x, offsets, square=True)

    def compare(what, xin, cd, lanes, prologue="identity", census=False, chain=(),
                bitwise=False, case=None):
        offs, m, m_sq, fetch, cover = case or (offsets, mass, mass_sq, fetched, cover_src.size)
        before, tr = ops.mma_sum_segments.launches, []
        got = ops.mma_sum_segments(xin, offs, compute_dtype=cd, prologue=prologue,
                                   census=census, epilogue=chain, num_lanes=lanes, trace=tr)
        launched = ops.mma_sum_segments.launches - before
        want = ops.mma_sum_segments_plain(xin, offs, cd, prologue, chain, census, lanes)
        torch.cuda.synchronize()
        nseg = len(offs) - 1
        sq = prologue in ("square", "moments")
        tol = 2.0**-16 * (m_sq if sq else m) + 1e-6
        if chain:  # (sqrt, clip): d clip / d t <= 1 / t near the clip point; d sqrt = dt / 2 sqrt t
            tol = tol / (2 * torch.sqrt(m_sq.clamp_min(1.0)))
        g, w = got[:nseg].double(), want[:nseg].double()
        err = float((g - w).abs().nan_to_num(0.0).max())
        ok = bool(torch.all(((g - w).abs() <= tol) | (g == w) | (g.isnan() & w.isnan())))
        if prologue == "moments":
            ok &= bool(torch.all((got[nseg:].double() - want[nseg:].double()).abs()
                                 <= 2.0**-16 * m_sq + 1e-6))
        if census:
            ok &= torch.equal(got[nseg:], want[nseg:])
        same = torch.equal(got.nan_to_num(), want.nan_to_num())
        model = cost_model.segmented_hbm_bytes(fetch, xin.element_size(), segments=got.numel(),
                                               tiles=cover, num_cores=lanes)
        print(f"K8 mma_sum_segments {what}, {tr[0].num_cores} lanes: max_abs_err {err:.3g} vs "
              f"plain (tol 2^-16 x segment mass{'; counts exact' if census else ''}), bitwise "
              f"{same}; {launched} launch, {tr[0].launch_io_bytes} bytes at the launch "
              f"(cost model {model.launch_io}; {fetch - xin.numel()} elements read twice at "
              "unaligned boundaries)")
        check(ok, f"K8 {what} ({lanes} lanes) disagrees with its plain version")
        check(not bitwise or same, f"K8 {what}: f32 compute is not bitwise its plain version")
        check(launched == 1, f"K8 {what}: {launched} launches")
        check(tr[0].launch_io_bytes == model.launch_io,
              f"K8 {what}: launch bytes {tr[0].launch_io_bytes} != model {model.launch_io}")
        return got, want

    for lanes_ in (lanes, 1):
        compare("2^28 f32 at bf16 compute", x, bf, lanes_)
    compare("2^28 f32, square at f32 compute", x, f32, lanes, "square", bitwise=True)
    compare("2^28 f32, moments at bf16 compute", x, bf, lanes, "moments")
    got, _ = compare("2^28 f32, square at f32, chain sqrt+clip", x, f32, lanes, "square",
                     chain=(("sqrt",), ("clip_coeff", 100.0, 1e-9)))
    check(bool(torch.all(got[[0, nseg // 3, 2 * nseg // 3]] == 1.0)),
          "K8: an empty segment's slot is not the chain of 0")
    xb = x.to(bf)
    compare("2^28 bf16", xb, bf, lanes)
    bad = x.clone()
    bad[[5, int(offsets[nseg // 2]), MULTI_N - 1]] = torch.tensor([float("nan"), float("inf"),
                                                             float("-inf")], device=DEVICE)
    got, _ = compare("2^28 f32, census on planted NaN/Inf", bad, bf, lanes, census=True)
    check(float(got[nseg:].sum()) == 3.0, "K8 census total is not 3")
    del bad
    # More lanes than CTAs stay resident (two a SM at 16-bit input, one at
    # f32): a CTA's lane is its own, launched in later waves.
    compare("2^28 bf16, 2000 lanes", xb, bf, 2000)
    compare("2^28 f32, square at f32 compute, 2000 lanes", x, f32, 2000, "square", bitwise=True)
    # An unaligned buffer (one element off 16 bytes: every tile by element
    # loads) whose last block is clipped at n (not a multiple of 8), in 128
    # ragged segments; interior tiles, cut tiles, empty segments.
    n_u = 2**24 + 5
    offs_u = tuple(int(o) for o in packed_offsets(n_u, 128, 1))
    for what, xu in (("f32", x[1:1 + n_u]), ("bf16", xb[1:1 + n_u])):
        cover_u = ops.segment_cover_layout(offs_u, ops.TILE)[1]
        case = (offs_u, _segment_mass(xu, offs_u), _segment_mass(xu, offs_u, square=True),
                ops._cover_fetched_elems(cover_u, n_u, ops.TILE), cover_u.size)
        check(xu.data_ptr() % 16 != 0, "the unaligned case is aligned")
        compare(f"2^24 + 5 {what}, unaligned base, clipped block, 128 segments", xu, bf, lanes,
                case=case)
        compare(f"2^24 + 5 {what}, unaligned base, square at f32 compute", xu, f32, lanes,
                "square", bitwise=True, case=case)
        xc = xu.clone()
        xc[[3, n_u // 2, n_u - 1]] = torch.tensor([float("nan"), float("inf"), float("-inf")],
                                                  device=DEVICE).to(xu.dtype)
        xcu = torch.empty((n_u + 1,), dtype=xu.dtype, device=DEVICE)[1:]
        xcu.copy_(xc)
        got, _ = compare(f"2^24 + 5 {what}, unaligned base, census", xcu, bf, 7, census=True,
                         case=case)
        check(float(got[len(offs_u) - 1:].sum()) == 3.0, "K8 census total is not 3 (unaligned)")

    lengths = torch.from_numpy(np.diff(offsets)).to(DEVICE)

    def timings(xin):
        n, isz = xin.numel(), xin.element_size()
        b, by = bound_ms(n * isz + nseg * 4, tensor_flops=16 * n)
        return {
            "ms": device_ms(lambda: ops.mma_sum_segments(xin, offsets, num_lanes=lanes),
                            "::segments_kernel<", iters=10),
            "call_ms": time_ms(lambda: ops.mma_sum_segments(xin, offsets, num_lanes=lanes),
                               iters=10),
            "plain_ms": time_ms(lambda: ops.mma_sum_segments_plain(
                xin, offsets, bf, "identity", (), False, lanes), iters=1, warmup=1),
            "bound_ms": b, "bound_by": by,
            "bound_fetched_ms": fetched * isz / HBM_BYTES_PER_S * 1e3,
            "library_ms": device_ms(lambda: torch.segment_reduce(xin, "sum", lengths=lengths),
                                    iters=10),
        }

    results["mma_sum_segments"] = dict(
        timings(x), at_2e28_bf16=timings(xb),
        max_abs_err=float((ops.mma_sum_segments(x, offsets, num_lanes=lanes)
                           - ops.mma_sum_segments_plain(x, offsets, bf, "identity", (), False,
                                                        lanes)).abs().max()))
    print(f"K8 timings at 2^28 f32 / bf16 ({lanes} lanes): device "
          f"{results['mma_sum_segments']['ms']:.4f} / "
          f"{results['mma_sum_segments']['at_2e28_bf16']['ms']:.4f} ms")


# K9's time per call at 2^28 f32 / bf16 before the look-back kernel: the
# one-SM kernel it replaced, by CUDA events on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md's table of kernels); printed beside this run's time, not
# measured here.
K9_ONE_SM_MS = {"float32": 201.631, "bfloat16": 178.206}


def check_scan(results: dict, gen) -> None:
    """K9 at 2^28 f32 (f32 compute: bitwise its plain version, the same
    adds in the same order) and bf16 (bf16 compute on the tensor cores:
    within one bf16 ulp of the output plus 2^-17 of the running mass --
    f32 sums of the same products in another order, then the same rounding
    to bf16); bitwise at 1, 2, 4 and 8 lanes, across five launches, and
    the exclusive scan the inclusive one shifted, at 2^24; one launch,
    launch-boundary bytes (input, output and look-back state) against the
    kernel's model ``cost_model.lookback_scan_hbm_bytes`` (the reference's
    striped ``scan_hbm_bytes`` printed beside it)."""
    import torch

    from repro_torch.core import cost_model
    from repro_torch.kernels.scan import ops as sops

    x = torch.randn((MULTI_N,), generator=gen, device=DEVICE) + 0.1
    for what, xin in (("2^28 f32", x), ("2^28 bf16", x.to(torch.bfloat16))):
        before, tr = sops.mma_scan.launches, []
        got = sops.mma_scan(xin, trace=tr)
        launched = sops.mma_scan.launches - before
        want = sops.mma_scan_plain(xin)[:MULTI_N]
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        model = cost_model.lookback_scan_hbm_bytes(MULTI_N, xin.element_size())
        striped = cost_model.scan_hbm_bytes(MULTI_N, xin.element_size())
        if xin.dtype == torch.float32:
            ok = torch.equal(got, want)
            tol_text = "bitwise"
        else:
            run = torch.cumsum(xin.double().abs(), 0)
            ok = bool(torch.all((got.double() - want.double()).abs()
                                <= 2.0**-8 * want.double().abs() + 2.0**-17 * run + 1e-6))
            tol_text = "1 bf16 ulp + 2^-17 x running mass"
            del run
        rel = float(((got.double() - torch.cumsum(xin.double(), 0)).abs()).max())
        print(f"K9 mma_scan {what}: max_abs_err {err:.3g} vs plain (tol {tol_text}); max |d| "
              f"vs f64 cumsum {rel:.4g} at a final value {float(want[-1]):.6g}; {launched} "
              f"launch, {tr[0].launch_io_bytes} bytes at the launch (the kernel's model "
              f"{model.launch_io}; the reference's striped model {striped.launch_io} + "
              f"{striped.refetch_read} refetched at one lane)")
        check(ok, f"K9 {what} disagrees with its plain version")
        check(launched == 1, f"K9 {what}: {launched} launches")
        check(tr[0].launch_io_bytes == model.launch_io, f"K9 {what}: launch bytes off the model")
        del got, want
    small = x[:2**24]
    for xin in (small, small.to(torch.bfloat16)):
        outs = [sops.mma_scan(xin, num_lanes=c, tiles_per_block=1) for c in (1, 2, 4, 8)]
        outs += [sops.mma_scan(xin) for _ in range(5)]
        exc = sops.mma_scan(xin, inclusive=False)
        torch.cuda.synchronize()
        same = [torch.equal(o, outs[0]) for o in outs]
        shift = torch.equal(exc[1:], outs[0][:-1]) and float(exc[0]) == 0.0
        print(f"K9 2^24 {str(xin.dtype)[6:]}: bitwise at 1/2/4/8 lanes and across five more "
              f"launches {same}; exclusive is the inclusive shifted {shift}")
        check(all(same), "K9 output differs between lane counts or launches")
        check(shift, "K9 exclusive scan is not the inclusive one shifted")
        del outs, exc

    def timings(xin):
        n, isz = xin.numel(), xin.element_size()
        b, by = bound_ms(2 * n * isz, tensor_flops=3 * 2 * 128 * n)
        return {
            "ms": device_ms(lambda: sops.mma_scan(xin), "::scan_kernel<", iters=10),
            "call_ms": time_ms(lambda: sops.mma_scan(xin), iters=20),
            "plain_ms": time_ms(lambda: sops.mma_scan_plain(xin), iters=1, warmup=0),
            "bound_ms": b, "bound_by": by,
            "library_ms": device_ms(lambda: torch.cumsum(xin, 0)),
        }

    results["mma_scan"] = dict(timings(x), at_2e28_bf16=timings(x.to(torch.bfloat16)),
                               max_abs_err=0.0)
    for what, r, dt in (("f32", results["mma_scan"], "float32"),
                        ("bf16", results["mma_scan"]["at_2e28_bf16"], "bfloat16")):
        print(f"K9 at 2^28 {what}: device {r['ms']:.4f} ms (profiler), call {r['call_ms']:.4f} "
              f"ms (CUDA events) (bound {r['bound_ms']:.4f}, torch.cumsum {r['library_ms']:.4f}; "
              f"the one-SM kernel it replaced: {K9_ONE_SM_MS[dt]} ms, from PERF.md, not this run)")


def check_parts_bf16(results: dict, gen) -> None:
    """K4 completed, over full-width olmo-1b's 113 parameter leaves (f32,
    1.18 B elements): ``mma_sum_parts`` at bf16 compute (kind sum) and
    with moments parts, against its plain version. Tolerance 2^-16 of each
    leaf's mass: the same element roundings, summed in f32 in another order
    on the tensor cores. Also times K1 at bf16 compute over one buffer of the
    same elements: the difference estimates what K4's folds add."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import mma_sum_fused
    from repro_torch.kernels.mma_reduce import default_num_lanes, ops

    leaves = [torch.randn(shape, generator=gen, device=DEVICE) * 0.02
              for shape in olmo_leaf_shapes(get_arch("olmo-1b"))]
    s = len(leaves)
    total = sum(p.numel() for p in leaves)
    absmass = torch.stack([p.double().abs().sum() for p in leaves])
    sqmass = torch.stack([(p.double() ** 2).sum() for p in leaves])
    figures = {}
    for pro in ("identity", "moments"):
        got = ops.mma_sum_parts(leaves, compute_dtype=torch.bfloat16, prologue=pro)
        again = ops.mma_sum_parts(leaves, compute_dtype=torch.bfloat16, prologue=pro)
        want = ops.mma_sum_parts_plain(leaves, (pro,) * s, (), False, torch.bfloat16)
        torch.cuda.synchronize()
        ok = bool(torch.all((got[:s].double() - want[:s].double()).abs()
                            <= 2.0**-16 * absmass + 1e-6))
        if pro == "moments":
            ok &= bool(torch.all((got[s:].double() - want[s:].double()).abs()
                                 <= 2.0**-16 * sqmass + 1e-6))
        err = float((got - want).abs().max())
        print(f"K4 mma_sum_parts at bf16 compute, {pro}, {s} f32 leaves ({total} elements): "
              f"max_abs_err {err:.3g} vs plain (tol 2^-16 x leaf mass); repeat bitwise "
              f"{torch.equal(got, again)}")
        check(ok, f"K4 at bf16 compute ({pro}) disagrees with its plain version")
        check(torch.equal(got, again), f"K4 at bf16 compute ({pro}): a second launch differs")
        nbytes = total * 4 + got.numel() * 4
        b, by = bound_ms(nbytes, tensor_flops=(32 if pro == "moments" else 16) * total)

        def k4(pro=pro):
            return ops.mma_sum_parts(leaves, compute_dtype=torch.bfloat16, prologue=pro)

        figures[pro] = {"max_abs_err": err, "ms": time_ms(k4, iters=3, warmup=1),
                        "plain_ms": time_ms(lambda pro=pro: ops.mma_sum_parts_plain(
                            leaves, (pro,) * s, (), False, torch.bfloat16), iters=1, warmup=0),
                        "bound_ms": b, "bound_by": by, "library_ms": None}
        print(f"K4 at bf16 compute, {pro}: {figures[pro]['ms']:.4f} ms per call (CUDA events), "
              f"bound {b:.4f} ms by {by}")
    flat = torch.cat([p.reshape(-1) for p in leaves])
    del leaves
    stream_ms = time_ms(lambda: mma_sum_fused(flat, compute_dtype=torch.bfloat16,
                                              num_lanes=default_num_lanes(flat)),
                        iters=3, warmup=1)
    for fig in figures.values():
        fig["stream_ms"] = stream_ms
        fig["fold_estimate_ms"] = fig["ms"] - stream_ms
    print(f"K4 at bf16 compute: K1 over the same {total} f32 elements at bf16 compute "
          f"{stream_ms:.4f} ms; fold_estimate_ms {figures['identity']['fold_estimate_ms']:.4f} "
          f"(sum), {figures['moments']['fold_estimate_ms']:.4f} (moments)")
    results["mma_sum_parts"]["bf16_compute"] = figures
    del flat
    torch.cuda.empty_cache()


def check_multi_against_cpu(gen) -> None:
    """``reduce_many`` (both axes, every backend and kind), ``scan`` (every
    backend) and ``reduce_tree``'s gradient (the kernel backends) on the
    card against the same calls on the CPU (the kernels' plain versions;
    "segmented" against the executor it picks on the card) at 2^20.
    Tolerance as the ``reduce`` check: the compute dtype's unit roundoff
    / 64 of the mass (f32 noise at f32 compute); per element of a scan,
    2^-18 of the running mass."""
    import torch

    from repro_torch import reduce as R

    sizes = (300, 0, 20000, 2**20 - 20300)
    x = torch.randn((2**20,), generator=gen, device=DEVICE) * 2 + 0.3
    parts = list(torch.split(x, sizes))
    cparts = [p.cpu() for p in parts]
    worst = 0.0
    for backend in R.available_backends():
        cpu_backend = (R.segmented_backend_for(x.numel(), x.dtype, 128, x.device)
                       if backend == "segmented" else backend)
        for kind in ("sum", "mean", "sumsq", "norm2", "moments"):
            cd = R.plan_for((x.numel(),), x.dtype, kind=kind, backend=cpu_backend,
                            segments=len(parts)).compute_torch
            unit = max(_unit(cd) / 64, 2.0**-20)
            got = R.reduce_many(parts, kind=kind, backend=backend)
            want = R.reduce_many(cparts, kind=kind, backend=cpu_backend)
            pairs = zip(got, want, ("sum", "sumsq")) if kind == "moments" else [(got, want, kind)]
            for g, w, k in pairs:
                for i, p in enumerate(cparts):
                    v = p.double() ** 2 if k in ("sumsq", "norm2") else p.double().abs()
                    tol = unit * float(v.sum()) + 1e-6
                    tol = tol / max(p.numel(), 1) if k == "mean" else tol
                    tol = tol / (2 * max(float(w[i]), 1e-3)) if k == "norm2" else tol
                    err = abs(float(g[i]) - float(w[i]))
                    worst = max(worst, err / tol)
                    check(g.device.type == "cuda" and err <= tol,
                          f"reduce_many({kind}, {backend}) slot {i}: card {float(g[i])} vs CPU "
                          f"{float(w[i])}")
            rows = [x[:3 * 1000].view(3, 1000), x[:0].view(0, 7), x[5000:5000 + 4 * 700].view(4, 700)]
            got = R.reduce_many(rows, kind=kind, axis=-1, backend=backend)
            want = R.reduce_many([r.cpu() for r in rows], kind=kind, axis=-1, backend=cpu_backend)
            flat_g = got[0] + got[1] if kind == "moments" else got
            flat_w = want[0] + want[1] if kind == "moments" else want
            for g, w in zip(flat_g, flat_w):
                check(tuple(g.shape) == tuple(w.shape) and bool(torch.allclose(
                    g.cpu(), w, rtol=unit * 64, atol=unit * 64 * 100)),
                    f"reduce_many({kind}, axis=-1, {backend}): card and CPU differ")
        # scans of every backend against themselves on the CPU ("segmented"
        # has no scan of its own: the base cumsum on either device); f32
        # compute, so f32 order noise of the running mass (cumsum is a
        # parallel scan on the card, double-accumulated on the CPU)
        y = x[:2**20 - 7]
        got = R.scan(y, backend=backend).cpu().double()
        want = R.scan(y.cpu(), backend=backend).double()
        run = torch.cumsum(y.cpu().double().abs(), 0)
        check(bool(torch.all((got - want).abs() <= 2.0**-18 * run + 1e-5)),
              f"scan({backend}): card and CPU differ")
    print(f"reduce_many card vs CPU, 2^20 f32 in 4 arrays (one empty), "
          f"{len(R.available_backends())} backends x 5 kinds, both axes, and scan: within "
          f"tolerance (worst |d| / tol of the full reductions {worst:.3g})")
    for backend in ("cuda_fused", "cuda_hier"):
        grads = []
        for ps in (parts, cparts):
            leaves = [p.detach().clone().requires_grad_(True) for p in ps]
            out = R.reduce_tree(leaves, "norm2", backend=backend,
                                epilogue=[(), ("clip_coeff", 1.0)])
            grads.append(torch.autograd.grad((out * torch.tensor([1.0, 3.0], device=out.device))
                                             .sum(), leaves, allow_unused=True))
        for g, c in zip(*grads):
            check((g is None) == (c is None) and (g is None or bool(torch.allclose(
                g.cpu(), c, rtol=1e-4, atol=1e-9))), f"reduce_tree gradient ({backend}) differs")
    print("reduce_tree(norm2, clip fork) gradients card vs CPU on cuda_fused and cuda_hier: "
          "within 1e-4 relative")


def check_packing_offsets(gen) -> None:
    """``packing_offsets`` of 2048 lengths (total below 2^24, so f32 is
    integer-exact) on ``cuda_fused`` (the scan kernel on the f32 copy of
    the lengths): exactly the host's int64 cumsum."""
    import numpy as np
    import torch

    from repro_torch.data import packing_offsets

    lengths = torch.randint(0, 8000, (SEGMENTS,), generator=gen, device=DEVICE).to(torch.int32)
    lengths[[3, SEGMENTS // 2]] = 0
    got = packing_offsets(lengths, backend="cuda_fused")
    want = np.concatenate([[0], np.cumsum(lengths.cpu().numpy().astype(np.int64))])
    print(f"packing_offsets of {SEGMENTS} lengths on cuda_fused: total {int(want[-1])} "
          f"(< 2^24), equal to the int64 cumsum {bool(np.array_equal(got.cpu().numpy(), want))}")
    check(int(want[-1]) < 2**24 and got.dtype == torch.int32
          and got.device.type == torch.device(DEVICE).type
          and np.array_equal(got.cpu().numpy(), want), "packing_offsets differs from cumsum")


def run_multi_reduce_path() -> dict:
    """The slice's main path, every kernel launch counted: ``reduce_many``
    over 2^28 f32 values in 2048 packed segments (more than 128 arrays:
    the pack and ONE launch of K8), ``reduce_many`` kinds sum and moments
    over olmo-1b's 113 parameter leaves (one K4 launch each, bf16
    compute), ``repro_torch.scan`` over 2^28 f32 and bf16 values (the auto
    route on the card: one K9 launch each) and ``packing_offsets`` on
    ``cuda_fused`` (one K9 launch). Returns the launch counts."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import reduce as R
    from repro_torch.configs import get_arch
    from repro_torch.data import packing_offsets
    from repro_torch.launch.reduce_demo import packed_offsets

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    x = torch.randn((MULTI_N,), generator=gen, device=DEVICE) + 1.0
    offsets = packed_offsets(MULTI_N, SEGMENTS, 1)
    docs = list(torch.split(x, np.diff(offsets).tolist()))
    leaves = [torch.randn(shape, generator=gen, device=DEVICE) * 0.02
              for shape in olmo_leaf_shapes(get_arch("olmo-1b"))]
    lengths = torch.randint(0, 8000, (SEGMENTS,), generator=gen, device=DEVICE).to(torch.int32)
    xb = x.to(torch.bfloat16)

    def path():
        return (R.reduce_many(docs, backend="cuda_fused"),
                R.reduce_many(leaves, kind="sum", backend="cuda_fused"),
                R.reduce_many(leaves, kind="moments", backend="cuda_fused"),
                repro_torch.scan(x), repro_torch.scan(xb),
                packing_offsets(lengths, backend="cuda_fused"))

    t0 = time.perf_counter()
    out, launches = counted_run(path)
    wall = time.perf_counter() - t0
    per_doc, leaf_sums, (leaf_s, leaf_ss), prefix, prefix_b, offs = out
    print(f"multi-reduce and scan path: {wall:.2f} s; launches {launches}")
    check(per_doc.shape == (SEGMENTS,) and bool(torch.isfinite(per_doc).all()),
          "reduce_many over the packed documents: bad result")
    lens = torch.from_numpy(np.diff(offsets)).to(x.device)
    exact = torch.zeros(SEGMENTS, dtype=torch.float64, device=x.device).index_add_(
        0, torch.repeat_interleave(torch.arange(SEGMENTS, device=x.device), lens), x.double())
    check(bool(torch.all((per_doc.double() - exact).abs()
                         <= 2.0**-8 * _segment_mass(x, offsets) + 1e-3)),
          "reduce_many over the packed documents is off the f64 sums by more than bf16 rounding")
    check(bool(torch.isfinite(leaf_sums).all() and torch.isfinite(leaf_ss).all()
               and torch.all(leaf_ss >= 0)), "reduce_many over the olmo leaves: bad result")
    check(prefix.shape == x.shape and prefix_b.dtype == torch.bfloat16
          and abs(float(prefix[-1]) - float(x.double().sum())) <= 1e-3 * float(x.double().sum()),
          "scan of 2^28: bad result")
    check(int(offs[-1]) == int(lengths.long().sum()), "packing offsets: bad total")
    check(launches["mma_sum_segments"] == 1 and launches["mma_sum_parts"] == 2
          and launches["mma_scan"] == 3,
          f"the multi-reduce path ran {launches} launches, expected K8 1, K4 2, K9 3")
    return launches


def run_reduce_demo() -> dict:
    """The paper's main path: ``launch.reduce_demo``'s ``main`` at n = 2^28
    on the card, every kernel launch counted. Returns the launch counts."""
    import numpy as np

    from repro_torch.launch import reduce_demo

    t0 = time.perf_counter()
    out, launches = counted_run(lambda: reduce_demo.main(["--n", str(PAPER_N)]))
    wall = time.perf_counter() - t0
    print(f"reduce demo at n = {PAPER_N}: {wall:.2f} s; launches {launches}")
    for n, m, levels, steps, eq16, _, s_meas, s17 in out["steps"]:
        check(steps == 5 * levels and abs(eq16 - steps) < 1e-9 and abs(s_meas - s17) < 1e-9,
              f"step counts at n={n}, m={m} differ from eqs. 16-17")
    rel = {name: r for name, _, r in out["precision"]}
    check(all(np.isfinite(v) for v in rel.values()), "non-finite precision row")
    check(rel["cuda_fused f32 multipliers, kahan"] <= 1e-6, "Kahan's error is above 1e-6")
    check(all(ms > 0 for _, ms in out["times"]), "a time per call is not positive")
    seg = out["segments"]
    check(seg["count"] == 2048 and seg["worst_rel_to_mass"] <= 2.0**-8 and seg["ms"] > 0,
          "the demo's segmented section: bad result")
    for n, got, exact in seg["three"]:
        check(abs(got - exact) <= 1e-4 * exact, "the demo's three segments are off f64")
    for name in PAPER_KERNELS + ("mma_sum_segments",):
        check(launches[name] > 0, f"the paper's path did not launch {name}")
    # the roofline section: a reading under the cold bound would beat the
    # card, so the bound's arithmetic would be wrong
    for backend, kernel, dt, ms, bound, share in out["measured"]:
        check(share >= ROOFLINE_FLOOR,
              f"{kernel} ({backend}) at {dt}: {ms * 1e3:.2f} us per call, under "
              f"{ROOFLINE_FLOOR} x its cold bound {bound * 1e3:.2f} us")
    check(len(out["roofline"]) == 6 and all(
        r.tensor_core_bandwidth_neutral for n, m, r, _ in out["roofline"] if m == 128),
        "the roofline table: the MMA encoding is not bandwidth-neutral at m = 128 for bf16")
    return launches


def check_backward_times(results: dict, gen) -> None:
    """Device time of the torch-math backward passes of K5 (layernorm_np,
    the reference's host math) and K6 (dense recompute) at the training
    shapes; no kernel of this repository runs in them."""
    import torch

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.row_moments.ops import layernorm_np_bwd

    x = torch.randn((TRAIN_BATCH * TRAIN_SEQ, 2048), generator=gen, device=DEVICE).to(torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    q, k, v = ((torch.randn((TRAIN_BATCH, 16, TRAIN_SEQ, 128), generator=gen, device=DEVICE)
                * 0.5).to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    go = torch.randn(q.shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    results["backward"] = {
        "layernorm_np_bwd_ms": device_ms(lambda: layernorm_np_bwd(x, g, 1e-5)),
        "attention_bwd_ms": device_ms(lambda: torch.autograd.grad(
            attention_ref(q, k, v, causal=True), (q, k, v), go), iters=5),
    }
    print(f"backward passes (torch math): layernorm_np ({x.shape[0]}, 2048) bf16 "
          f"{results['backward']['layernorm_np_bwd_ms']:.4f} ms; attention "
          f"{tuple(q.shape)} bf16, dense recompute {results['backward']['attention_bwd_ms']:.4f} ms")


# ------------------- the fused matmul with its row moments (K11) -------------------

# olmo-1b's MLP down projection: X is the training batch's (4 x 512, d_ff)
# hidden activations, W the (d_ff, d_model) projection, so Y's rows have the
# width of the LayerNorm that follows. The training rows at bf16 (timed:
# the kernel's main figures), the serving prefill's rows, and f32 operands
# (the in-kernel cast).
MS_CASES = ((TRAIN_BATCH * TRAIN_SEQ, "bfloat16"), (SLOTS * PROMPT, "bfloat16"),
            (TRAIN_BATCH * TRAIN_SEQ, "float32"))
MS_TOL = 1e-5  # s, ss: this fraction of each row's sum of |y|, of y^2


def ms_operands(m: int, dtype: str, gen):
    import torch

    from repro_torch.configs import get_arch

    cfg = get_arch("olmo-1b")
    x = torch.randn((m, cfg.d_ff), generator=gen, device=DEVICE).to(getattr(torch, dtype))
    w = (torch.randn((cfg.d_ff, cfg.d_model), generator=gen, device=DEVICE) * 0.02).to(
        getattr(torch, dtype))
    return x, w


def ms_compare(x, w, got, want):
    """(max |dY|, worst |ds| / sum|y|, worst |dss| / sum y^2, ok): Y within
    one ulp of its dtype plus two f32 ulps of the product's absolute mass
    per accumulation step of 16 (the tensor cores' f32 accumulation may
    truncate; the other side sums in another order); s and ss within
    ``MS_TOL`` of each row's sum of |y| and of y^2 (both sides sum the f32
    accumulator, not the stored Y)."""
    import torch

    from repro_torch.kernels.common import bf16_round

    (y, s, ss), (yp, sp, ssp) = got, want
    xb, wb = bf16_round(x.float()), bf16_round(w.float())
    mass = xb.abs() @ wb.abs()
    ulp = {torch.float32: 2.0**-23, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}[y.dtype]
    dy = (y.float() - yp.float()).abs()
    ok_y = bool(torch.all(dy <= ulp * yp.float().abs()
                          + 2.0**-22 * -(-x.shape[1] // 16) * mass + 1e-6))
    y32 = xb @ wb
    abs_mass, sq_mass = y32.abs().sum(-1), (y32 * y32).sum(-1)
    rs = float(((s - sp).abs() / (abs_mass + 1e-30)).max())
    rss = float(((ss - ssp).abs() / (sq_mass + 1e-30)).max())
    ok = ok_y and rs <= MS_TOL and rss <= MS_TOL
    return float(dy.max()), rs, rss, ok


def _ms_f64(x, w):
    """The f64 product of the bf16-rounded operands and its row moments."""
    from repro_torch.kernels.common import bf16_round

    y64 = bf16_round(x.float()).double() @ bf16_round(w.float()).double()
    return y64, y64.sum(-1), (y64 * y64).sum(-1)


def check_matmul_stats(results: dict, gen) -> None:
    """K11 against its plain version at the three full-width cases: Y, s and
    ss within ``ms_compare``'s tolerance, two launches bitwise the same, one
    launch per call; each side's moments against the f64 product, and the
    moments of the stored, rounded Y against ``MS_TOL`` (at bf16 they must
    fail it: the tolerance can tell the accumulator's moments from the
    output's). Card against CPU on a ragged case and on a K that is not
    16-byte aligned. Timed at each case, with the achieved TFLOP/s; the
    library time is ``torch.matmul`` on the same bf16 operands, the product
    alone, with the product plus the two row reductions of its result
    beside it. Then the full-width cases of the element loads
    (``check_matmul_stats_staging``)."""
    import torch

    from repro_torch.kernels import matmul_stats
    from repro_torch.kernels.matmul_stats import matmul_stats_plain

    for m, k, n, dtype in ((100, 500, 300, torch.bfloat16), (64, 100, 96, torch.bfloat16),
                           (33, 65, 129, torch.float32)):
        x = torch.randn((m, k), generator=gen, device=DEVICE).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=DEVICE) * 0.1).to(dtype)
        got = matmul_stats(x, w)
        cpu = [t.to(DEVICE) for t in matmul_stats(x.cpu(), w.cpu())]
        torch.cuda.synchronize()
        dy, rs, rss, ok = ms_compare(x, w, got, cpu)
        print(f"K11 matmul_stats card vs CPU ({m}x{k})@({k}x{n}) {str(dtype)[6:]}: max |dY| "
              f"{dy:.3g}, s {rs:.3g} and ss {rss:.3g} of the row mass (tol {MS_TOL})")
        check(ok, f"K11 card and CPU disagree at ({m}, {k}, {n}) {dtype}")

    def library_moments(xb, wb):
        yl = torch.matmul(xb, wb).float()
        return yl.sum(-1), (yl * yl).sum(-1)

    timed = {}
    for m, dtype in MS_CASES:
        x, w = ms_operands(m, dtype, gen)
        k, n = w.shape
        what = f"({m}x{k})@({k}x{n}) {dtype}"
        before = matmul_stats.launches
        got = matmul_stats(x, w)
        launched = matmul_stats.launches - before
        again = matmul_stats(x, w)
        plain = matmul_stats_plain(x, w)
        torch.cuda.synchronize()
        dy, rs, rss, ok = ms_compare(x, w, got, plain)
        y64, s64, ss64 = _ms_f64(x, w)
        mass_s = y64.abs().sum(-1)
        del y64
        k_s = float(((got[1].double() - s64).abs() / mass_s).max())
        k_ss = float(((got[2].double() - ss64).abs() / ss64).max())
        p_s = float(((plain[1].double() - s64).abs() / mass_s).max())
        p_ss = float(((plain[2].double() - ss64).abs() / ss64).max())
        yr = got[0].double()
        r_s = float(((yr.sum(-1) - s64).abs() / mass_s).max())
        r_ss = float((((yr * yr).sum(-1) - ss64).abs() / ss64).max())
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"K11 matmul_stats {what}: vs plain max |dY| {dy:.3g}, s {rs:.3g} and ss "
              f"{rss:.3g} of the row mass (tol {MS_TOL}); vs the f64 product: kernel s "
              f"{k_s:.3g} / ss {k_ss:.3g}, plain s {p_s:.3g} / ss {p_ss:.3g}, sums of the "
              f"stored Y s {r_s:.3g} / ss {r_ss:.3g}; {launched} launch; repeat bitwise {same}")
        check(ok, f"K11 disagrees with its plain version at {what}")
        check(same, f"K11 {what}: a second launch differs")
        check(launched == 1, f"K11 {what}: {launched} launches for one call")
        check(k_s <= MS_TOL and k_ss <= MS_TOL, f"K11 {what}: moments off the f64 product")
        if dtype == "bfloat16":
            check(r_s > MS_TOL and r_ss > MS_TOL,
                  f"K11 {what}: the stored Y's sums pass the tolerance, which then cannot "
                  "tell them from the accumulator's")
        isz = x.element_size()
        b, by = bound_ms((x.numel() + w.numel() + m * n) * isz + 2 * m * 4,
                         tensor_flops=2 * m * n * k + 2 * 16 * m * n, core_flops=m * n)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        dev_ms = device_ms(lambda: matmul_stats(x, w), "matmul_stats_kernel")
        timed[(m, dtype)] = {
            "max_abs_err": dy, "s_err_rel": rs, "ss_err_rel": rss,
            "s_err_vs_f64": k_s, "ss_err_vs_f64": k_ss,
            "ms": dev_ms, "tflops": 2 * m * n * k / (dev_ms * 1e-3) / 1e12,
            "call_ms": time_ms(lambda: matmul_stats(x, w), iters=20),
            "plain_ms": device_ms(lambda: matmul_stats_plain(x, w), iters=3),
            "bound_ms": b, "bound_by": by,
            "library_ms": device_ms(lambda: torch.matmul(xb, wb)),
            "library_with_moments_ms": device_ms(lambda: library_moments(xb, wb)),
        }
        del x, w, xb, wb, got, again, plain, yr
    staging = check_matmul_stats_staging(gen)
    main_case = MS_CASES[0]
    results["matmul_stats"] = dict(timed[main_case], serving=timed[MS_CASES[1]],
                                   at_f32=timed[MS_CASES[2]], staging=staging)
    for (m, dtype), t in timed.items():
        print(f"K11 timings ({m} rows, {dtype}): device {t['ms'] * 1e3:.2f} us "
              f"({t['tflops']:.1f} TFLOP/s), call {t['call_ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.1f} us, torch.matmul {t['library_ms'] * 1e3:.2f} us (+ row "
              f"moments {t['library_with_moments_ms'] * 1e3:.2f} us), bound "
              f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}")


def check_matmul_stats_staging(gen) -> dict:
    """K11 at full width on the producer's element loads, which serve the
    operands TMA cannot take: bf16 X 2 bytes past a 16-byte boundary, and
    K = 8190 (rows of 16 380 bytes). The same checks as the main cases:
    ``ms_compare`` against the plain version, a bitwise repeat, one launch
    per call, and the moments within ``MS_TOL`` of the f64 product's."""
    import torch

    from repro_torch.kernels import matmul_stats
    from repro_torch.kernels.matmul_stats import matmul_stats_plain, ops

    m, n = TRAIN_BATCH * TRAIN_SEQ, 2048
    out = {}
    for name, k, offset in (("x at a 2-byte offset", 8192, 1), ("K = 8190", 8190, 0)):
        flat = torch.randn((m * k + 8,), generator=gen, device=DEVICE).to(torch.bfloat16)
        x = flat[offset:offset + m * k].view(m, k)
        w = (torch.randn((k, n), generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        routes = ops.load_routes(x, w)
        before = matmul_stats.launches
        got = matmul_stats(x, w)
        launched = matmul_stats.launches - before
        again = matmul_stats(x, w)
        plain = matmul_stats_plain(x, w)
        torch.cuda.synchronize()
        dy, rs, rss, ok = ms_compare(x, w, got, plain)
        y64, s64, ss64 = _ms_f64(x, w)
        k_s = float(((got[1].double() - s64).abs() / y64.abs().sum(-1)).max())
        k_ss = float(((got[2].double() - ss64).abs() / ss64).max())
        del y64
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        what = f"({m}x{k})@({k}x{n}) bf16, {name}"
        t = device_ms(lambda: matmul_stats(x, w), "matmul_stats_kernel", iters=5)
        print(f"K11 matmul_stats {what}: load routes (x, w) {routes}; vs plain max |dY| "
              f"{dy:.3g}, s {rs:.3g} and ss {rss:.3g} of the row mass (tol {MS_TOL}); vs the "
              f"f64 product s {k_s:.3g} / ss {k_ss:.3g}; {launched} launch; repeat bitwise "
              f"{same}; device {t * 1e3:.2f} us")
        check(routes[0] == ops.ROUTE_ELEM, f"K11 {what}: x should take the element loads")
        check(ok, f"K11 disagrees with its plain version at {what}")
        check(same, f"K11 {what}: a second launch differs")
        check(launched == 1, f"K11 {what}: {launched} launches for one call")
        check(k_s <= MS_TOL and k_ss <= MS_TOL, f"K11 {what}: moments off the f64 product")
        out[name] = {"ms": t, "max_abs_err": dy, "s_err_vs_f64": k_s, "ss_err_vs_f64": k_ss,
                     "routes": list(routes)}
        del flat, x, w, got, again, plain
    return out


def run_matmul_stats_path() -> dict:
    """The K11 entry's main path, every kernel launch counted:
    ``repro_torch.kernels.matmul_stats`` at the three full-width cases (one
    launch each), each output checked: shapes and dtypes, finite values,
    ss >= s^2 / N (Cauchy-Schwarz), and s and ss within ``MS_TOL`` of the
    f64 product's. Returns the launch counts."""
    import torch

    from repro_torch.kernels import matmul_stats

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    operands = [ms_operands(m, dtype, gen) for m, dtype in MS_CASES]
    t0 = time.perf_counter()
    outs, launches = counted_run(lambda: [matmul_stats(x, w) for x, w in operands])
    wall = time.perf_counter() - t0
    print(f"matmul_stats path: {wall * 1e3:.2f} ms for {len(MS_CASES)} calls; launches "
          f"{launches}")
    for (x, w), (y, s, ss) in zip(operands, outs):
        m, n = x.shape[0], w.shape[1]
        check(y.shape == (m, n) and y.dtype == x.dtype and s.shape == ss.shape == (m,)
              and s.dtype == ss.dtype == torch.float32, "matmul_stats path: bad shapes or dtypes")
        check(bool(torch.isfinite(y.float()).all() & torch.isfinite(s).all()
                   & torch.isfinite(ss).all()), "matmul_stats path: non-finite output")
        check(bool(torch.all(ss.double() * (1 + 1e-6) >= s.double() ** 2 / n)),
              "matmul_stats path: ss < s^2 / N")
        y64, s64, ss64 = _ms_f64(x, w)
        mass_s = y64.abs().sum(-1)
        check(float(((s.double() - s64).abs() / mass_s).max()) <= MS_TOL
              and float(((ss.double() - ss64).abs() / ss64).max()) <= MS_TOL,
              "matmul_stats path: moments off the f64 product")
    check(launches["matmul_stats"] == len(MS_CASES),
          f"the matmul_stats path ran {launches['matmul_stats']} K11 launches, expected "
          f"{len(MS_CASES)}")
    return launches


# ------------------------------- model checks --------------------------------


def logit_sensitivity(eng, tokens, trials: int = 8) -> float:
    """The largest change of a CPU engine's prefill logits when its weights
    are multiplied by 1 + 1e-7 N(0, 1) (``trials`` seeds): the bf16
    roundings inside the kernels' plain versions (the norms' squares,
    attention's q, k, v and p) flip under such a change, as they may under
    the card's f32 sums in other orders."""
    import torch

    def perturbed(tree, gen):
        if isinstance(tree, torch.Tensor):
            return tree * (1 + 1e-7 * torch.randn(tree.shape, generator=gen))
        if isinstance(tree, dict):
            return {k: perturbed(v, gen) for k, v in tree.items()}
        return [perturbed(v, gen) for v in tree]

    worst = 0.0
    with torch.inference_mode():
        base, _ = eng._prefill(eng.params, tokens)
        for seed in range(trials):
            got, _ = eng._prefill(perturbed(eng.params, torch.Generator().manual_seed(seed)),
                                  tokens)
            worst = max(worst, float((got - base).abs().max()))
    return worst


def replay_kernels_on_card(eng, tokens) -> float:
    """Every kernel call of a CPU engine's prefill (the norms and attention,
    whose plain versions run there) replayed on the card with the same
    inputs: the largest difference between a kernel's output and its plain
    version's. It isolates the kernels from the rounding flips that the
    end-to-end comparison sees."""
    import torch

    from repro_torch import kernels as K

    names = ("flash_attention_diff", "rmsnorm", "layernorm_np")
    real = {name: getattr(K, name) for name in names}
    calls = []

    def recorder(name):
        def call(*args):
            out = real[name](*args)
            calls.append((name, args, out))
            return out
        return call

    for name in names:
        setattr(K, name, recorder(name))
    try:
        with torch.inference_mode():
            eng._prefill(eng.params, tokens)
    finally:
        for name in names:
            setattr(K, name, real[name])
    worst = 0.0
    with torch.inference_mode():
        for name, args, out in calls:
            dev = [a.to(DEVICE) if isinstance(a, torch.Tensor) else a for a in args]
            got = real[name](*dev).cpu().float()
            worst = max(worst, float((got - out.float()).abs().max()))
    check(bool(calls), "no kernel call was replayed")
    return worst


def prefill_with_wrong_kv_heads(eng, tokens):
    """The engine's prefill logits with a fault planted in attention: query
    head h reads kv head h mod Hkv (the right one is h // (Hq / Hkv)), or,
    with as many kv heads as query heads, kv head h + 1 mod Hkv. A limit
    on the card-vs-CPU logits must fail it."""
    import torch

    from repro_torch import kernels as K

    real = K.flash_attention_diff

    def wrong(q, k, v, *rest):
        hq, hkv = q.shape[1], k.shape[1]
        if hkv < hq:
            k, v = k.repeat(1, hq // hkv, 1, 1), v.repeat(1, hq // hkv, 1, 1)
        else:
            k, v = k.roll(1, 1), v.roll(1, 1)
        return real(q, k, v, *rest)

    K.flash_attention_diff = wrong
    try:
        with torch.inference_mode():
            logits, _ = eng._prefill(eng.params, tokens)
    finally:
        K.flash_attention_diff = real
    return logits


def _cross_kv_from_next_head(real):
    """A planted fault: the cross-attention's keys and values taken from
    the next kv head."""
    def wrong(p, ctx, cfg):
        k, v = real(p, ctx, cfg)
        return k.roll(1, 2), v.roll(1, 2)
    return wrong


def _gates_exchanged(real):
    """A planted fault: the RG-LRU's recurrence and input gates exchanged."""
    def wrong(p, u, cfg):
        return real(dict(p, gate_a=p["gate_x"], gate_x=p["gate_a"]), u, cfg)
    return wrong


def _ring_filled_at_slot_pos(real):
    """A planted fault: a ring filled at slot pos instead of pos % slots,
    as a cache without the ring would be: a prompt longer than the ring
    keeps its FIRST positions and loses the most recent ones."""
    def wrong(cache, k, v, slot0=0):
        s_max = cache["k"].shape[1]
        return real(cache, k[:, :s_max], v[:, :s_max], slot0)
    return wrong


@contextlib.contextmanager
def planted(module, name: str, make_wrong):
    """A context in which ``module.name`` is ``make_wrong(the real one)``."""
    real = getattr(module, name)
    setattr(module, name, make_wrong(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def prefill_with_planted_fault(eng, tokens):
    """The engine's prefill logits with a fault planted in the mixer, and
    what it was: a wrong kv-head mapping in K6 for the attention block
    (``prefill_with_wrong_kv_heads``); for MLA the chunked attention with
    k and v taken from the next head (it runs no K6); for the SSM block
    the SSD with B and C exchanged; for the RG-LRU hybrid the recurrence
    and input gates exchanged (with one kv head, a wrong kv-head mapping is
    no fault); for vision the cross-attention's k and v from the next kv
    head (with its gates open, ``open_gates``)."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import rglru as REC
    from repro_torch.models import ssm as S

    cfg = eng.cfg
    faults = {"rec": (REC, "_gates", _gates_exchanged, "the RG-LRU's gates exchanged"),
              "xattn": (A, "cross_kv", _cross_kv_from_next_head,
                        "the cross-attention's k and v from the next kv head")}
    for kind, (module, name, wrong, what) in faults.items():
        if kind in cfg.pattern_layers:
            with planted(module, name, wrong), torch.inference_mode():
                logits, _ = eng._prefill(eng.params, tokens)
            return logits, what
    if "ssm" in cfg.pattern_layers:
        module, name, what = S, "ssd_chunked", "B and C exchanged in the SSD"

        def wrong(x, dt, a, b, c, *rest, **kw):
            return real(x, dt, a, c, b, *rest, **kw)
    elif cfg.mla is not None:
        module, name, what = A, "flash_attention_xla", "k and v from the next head in MLA"

        def wrong(q, k, v, **kw):
            return real(q, k.roll(1, 2), v.roll(1, 2), **kw)
    else:
        return prefill_with_wrong_kv_heads(eng, tokens), "a wrong kv-head mapping"
    real = getattr(module, name)
    setattr(module, name, wrong)
    try:
        with torch.inference_mode():
            logits, _ = eng._prefill(eng.params, tokens)
    finally:
        setattr(module, name, real)
    return logits, what


def open_gates(params, value: float = 0.5) -> None:
    """Every cross-attention gate of ``params`` set to ``value`` in place:
    the gates are zero at init, and a closed gate adds nothing a check
    could see."""
    import torch

    with torch.no_grad():
        for layer in params["layers"]:
            if "gate" in layer["mix"]:
                layer["mix"]["gate"].fill_(value)


def check_tiny_against_cpu(arch: str = "olmo-1b") -> None:
    """Tiny ``arch`` (f32) served on the card with the kernels and on the CPU
    with their plain versions, from the same weights: the same greedy tokens,
    and prefill logits within 1e-3 for olmo (f32 sums in other orders; one
    bf16 rounding of an intermediate may flip). For the archs added later
    every kernel call of the CPU prefill is replayed on the card
    (``replay_kernels_on_card``: within 1e-5, f32 rounding), and the
    logits are held within 0.01. ``tools/logit_gap_probe.py`` set it: the
    f32 ops outside the kernels sum in other orders on the card, and where
    that carries one of the kernels' bf16-rounded operands (attention's q,
    k, v, the norms' squares) across a rounding boundary the flips cascade;
    over 32 weight seeds of the tiny dense archs at 2 and 4 kv heads the
    gap reached 0.0075 (GQA's share: 0, against the kv heads expanded onto
    the MHA path), and a planted fault moved the logits by at least 3.47
    (a wrong kv-head mapping), 0.18 (the softmax scale 10% off) and 0.018
    (1% off). A wrong kv-head mapping is planted here too and must fail
    the limit (``prefill_with_wrong_kv_heads``; for MLA and the SSM a fault
    of their own mixers, ``prefill_with_planted_fault``). For the MoE archs the
    routing of every layer's prefill (expert ids, slot tokens, the keep
    mask) must be equal on the card and the CPU. A vision arch runs with its
    cross-attention gates at 0.5 (``open_gates``) and the card engine's
    context on both devices. An audio arch's prefill reads (2, 12, 4)
    codebook tokens, each stream its own (the served 1-D prompts are tiled
    over the streams)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import GuardedEngine
    from repro_torch.runtime import Request, ServingRuntime

    cfg = get_arch(arch, tiny=True)
    gpu = GuardedEngine(cfg, 32, 2, seed=0)
    open_gates(gpu.params)
    cpu_params = _cpu_copy(gpu.params)
    cpu = GuardedEngine(cfg, 32, 2, device="cpu", params=cpu_params)
    if gpu.ctx is not None:
        cpu.ctx = gpu.ctx.cpu()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(12,)).astype(np.int32) for _ in range(3)]
    outs = []
    for eng in (gpu, cpu):
        res = ServingRuntime(eng).serve(
            [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)])
        check(all(r.ok for r in res), "tiny serving failed")
        outs.append([list(r.tokens) for r in res])
    with torch.inference_mode():
        packed = np.stack(prompts[:2]).astype(np.int64)
        if cfg.n_codebooks:  # every stream its own tokens (served prompts are tiled)
            packed = rng.integers(0, cfg.vocab_size, size=(2, 12, cfg.n_codebooks))
        (lg, _), routes_g = record_routing(
            lambda: gpu._prefill(gpu.params, torch.from_numpy(packed).to(DEVICE)))
        (lc, _), routes_c = record_routing(lambda: cpu._prefill(cpu.params,
                                                                torch.from_numpy(packed)))
        wrong, planted = prefill_with_planted_fault(gpu, torch.from_numpy(packed).to(DEVICE))
    if cfg.moe is not None:
        same = [all(torch.equal(getattr(g, f).cpu(), getattr(c, f))
                    for f in ("expert_ix", "slot_token", "keep"))
                for g, c in zip(routes_g, routes_c)]
        gate = max(float((g.slot_gate.cpu() - c.slot_gate).abs().max())
                   for g, c in zip(routes_g, routes_c))
        print(f"tiny {arch} f32, card vs CPU routing per layer (expert ids, slot tokens, keep) "
              f"equal: {same}; slot gates max |d| {gate:.3g}; drop fractions "
              f"{[round(x, 4) for x in drop_fractions(routes_g)]}")
        check(len(routes_g) == len(routes_c) == cfg.n_layers and all(same),
              f"tiny {arch}: the card and the CPU route differently")
    err = float((lg.cpu() - lc).abs().max())
    fault = float((wrong.cpu() - lc).abs().max())
    tol = 1e-3 if arch == "olmo-1b" else 0.01
    extra = ""
    if arch != "olmo-1b":
        replay = replay_kernels_on_card(cpu, torch.from_numpy(packed))
        sens = logit_sensitivity(cpu, torch.from_numpy(packed))
        extra = (f"; every kernel call replayed on the card: max_abs_err {replay:.3g} (tol "
                 f"1e-5); the CPU's own logits move by {sens:.3g} under 1e-7 relative weight "
                 "noise")
        check(replay <= 1e-5, f"tiny {arch}: a kernel differs from its plain version")
    print(f"tiny {arch} f32, card vs CPU: prefill logits max_abs_err {err:.3g} (tol {tol:.3g})"
          f"{extra}; greedy tokens equal: {outs[0] == outs[1]}; with {planted} planted on the "
          f"card: {fault:.3g} (must exceed the tol)")
    check(outs[0] == outs[1], f"tiny {arch}: card and CPU tokens differ")
    check(err <= tol, f"tiny {arch}: card and CPU logits differ")
    check(fault > tol, f"tiny {arch}: the limit passes {planted}")


def _cpu_copy(tree, device="cpu"):
    """A detached copy of a parameter tree on the CPU (or ``device``)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copy(v, device) for k, v in tree.items()}
    return [_cpu_copy(v, device) for v in tree]


def serve_full_width(arch: str = "olmo-1b", n_layers: int | None = None,
                     after=None) -> dict:
    """Full-width ``arch`` (its published depth, or ``n_layers``) through
    GuardedEngine + ServingRuntime, every kernel launch counted and held to
    the config's launch model (``launches_per_step``); the census total
    must be 0. For an MoE arch no kernel outside the model may launch (its
    routing's row sums and slot-base scan run in torch), and two prefills
    must agree bitwise (``check_moe_prefill``); the same for the MLA and
    SSM archs (``check_prefill_bitwise``) and those added later, and for
    the SSM and RG-LRU archs a retried decode step must be bitwise the
    clean one (``check_retry``; also for the audio arch, whose steps carry
    (4, 1, 4) codebook tokens). Prints tokens/s, the per-step latency
    p50/p99 and the bytes held on the card, then profiles a prefill and a
    decode step; ``after(engine)``, if given, runs last on the engine and
    adds its figures. Returns the launch counts and the figures."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import GuardedEngine
    from repro_torch.runtime import Request, ServingRuntime

    censuses = []

    class RecordingEngine(GuardedEngine):
        def start_wave(self, prompts, scales, backend):
            out = super().start_wave(prompts, scales, backend)
            censuses.append(out[2])
            return out

        def decode(self, state, scales, backend):
            out = super().decode(state, scales, backend)
            censuses.append(out[2])
            return out

    cfg = get_arch(arch)
    if n_layers is not None:
        print(f"{arch}: depth cut to {n_layers} of {cfg.n_layers} layers, full width")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = RecordingEngine(cfg, PROMPT + MAX_NEW + 1, SLOTS, seed=0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    print(f"{arch}: {cfg.param_count() / 1e9:.3f} B parameters ({cfg.n_layers} layers) "
          f"initialised on the card in {time.time() - t0:.1f} s; {held / 1e9:.2f} GB held on "
          "the card")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(PROMPT,)).astype(np.int32)
               for _ in range(REQUESTS)]
    # warm-up wave (cuBLAS handles, allocator): not counted, not timed
    ServingRuntime(eng).serve([Request(rid=0, prompt=prompts[0], max_new=2)])
    censuses.clear()
    runtime = ServingRuntime(eng)
    t0 = time.perf_counter()
    results, launches = counted_run(lambda: runtime.serve(
        [Request(rid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]))
    wall = time.perf_counter() - t0
    snap = runtime.metrics.snapshot()
    n_tok = sum(len(r.tokens) for r in results if r.ok)
    figures = {"tokens_per_s": n_tok / wall, "p50_ms": snap["token_latency_p50_s"] * 1e3,
               "p99_ms": snap["token_latency_p99_s"] * 1e3, "held_gb": held / 1e9,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{arch}: served {sum(r.ok for r in results)}/{REQUESTS} requests, {n_tok} tokens "
          f"in {wall:.3f} s: {figures['tokens_per_s']:.1f} tok/s; per-step latency p50 "
          f"{figures['p50_ms']:.2f} ms p99 {figures['p99_ms']:.2f} ms; breaker_trips "
          f"{snap['breaker_trips']}; peak device memory {figures['peak_gb']:.2f} GB; "
          f"launches {launches}")
    check(all(r.ok and len(r.tokens) == MAX_NEW for r in results), f"{arch}: serving did not "
          "complete")
    check(all(0 <= t < cfg.vocab_size for r in results for t in r.tokens),
          f"{arch}: token out of range")
    check(snap["breaker_trips"] == 0, f"{arch}: the breaker tripped")
    total_census = float(sum(float(c[-1]) for c in censuses))
    print(f"{arch}: census total over {len(censuses)} steps: {total_census}")
    check(total_census == 0.0, f"{arch}: non-finite logits in the full-width run")
    per_prefill, per_decode = launches_per_step(cfg)
    expected = {k: WAVES * (per_prefill[k] + (MAX_NEW - 1) * per_decode[k])
                for k in per_prefill}
    for k, n in expected.items():
        check(launches[k] == n, f"{arch}: {k}: {launches[k]} launches, expected {n}")
    if cfg.norm == "layernorm_np":
        check(launches["rmsnorm"] == 0, "rmsnorm is not on the olmo path")
    elif cfg.norm == "layernorm":
        check(launches["rmsnorm"] == launches["layernorm_np"] == 0,
              f"{arch}: a norm kernel launched for the parametric LayerNorm")
    else:
        check(launches["rmsnorm"] > 0 and launches["layernorm_np"] == 0,
              f"{arch}: K5b is not on the path")
    new_kind = (cfg.mla is not None or set(cfg.pattern_layers) != {"attn"}
                or bool(cfg.n_codebooks))
    if cfg.moe is not None or new_kind:
        others = {k: n for k, n in launches.items() if n and k not in expected}
        check(not others, f"{arch}: kernels outside the launch model launched: {others}")
    if cfg.moe is not None:
        figures.update(check_moe_prefill(eng, prompts[:SLOTS]))
    elif new_kind:
        figures.update(check_prefill_bitwise(eng, prompts[:SLOTS]))
    if {"ssm", "rec"} & set(cfg.pattern_layers) or cfg.n_codebooks:
        figures.update(check_retry(eng, prompts[:SLOTS]))
    figures.update(profile_steps(eng, prompts[:SLOTS]))
    if after is not None:
        figures.update(after(eng))
    del eng, runtime
    gc.collect()
    torch.cuda.empty_cache()
    return launches, figures


def profile_steps(eng, prompts) -> dict:
    """Where a step's time goes: the device's busy time per step (profiler:
    every kernel, memset and copy) against the step's wall time (host clock,
    measured without the profiler), and the kernels that take the most.
    Returns ``{"<step>_wall_ms", "<step>_busy_ms"}``."""
    import torch

    scales = [1.0] * SLOTS
    state, _, _ = eng.start_wave(prompts, scales, "cuda_fused")
    steps = {
        "prefill": lambda: eng.start_wave(prompts, scales, "cuda_fused"),
        # decode re-issued from one committed state: the in-place cache
        # write is idempotent, so every repeat is the same step
        "decode": lambda: eng.decode(state, scales, "cuda_fused"),
    }
    out = {}
    for name, step in steps.items():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
        per_step, _ = launches_per_step(eng.cfg)
        expect = {"::row_norm_kernel<": per_step["layernorm_np"] + per_step["rmsnorm"],
                  "::parts_kernel<": 1}
        if name == "prefill":
            expect[_attn_kernel(eng.cfg)] = per_step["flash_attention"]
        events, n = step_events(step, expect, f"the {name} step")
        busy_ms = sum(us for _, us in events.values()) / n / 1e3
        top = sorted(events.items(), key=lambda kv: kv[1][1], reverse=True)[:6]
        print(f"{eng.cfg.name} {name} step (4 slots): wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms over {n} steps, idle share "
              f"{max(0.0, 1.0 - busy_ms / wall_ms):.3f}")
        for key, (count, us) in top:
            print(f"    {us / n / 1e3:8.4f} ms/step  {count // n:4d}x  {key[:90]}")
        out[f"{name}_wall_ms"], out[f"{name}_busy_ms"] = wall_ms, busy_ms
    return out


def check_full_width_against_cpu() -> None:
    """Full-width olmo-1b cut to 2 layers: prefill logits and two decode
    steps on the card (kernels) against the CPU (plain versions) from the
    same bf16 weights. Tolerance 0.25 at |logit| ~ 4: the matmuls are bf16
    on both sides with different accumulation orders and roundings."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import GuardedEngine

    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=2)
    gpu = GuardedEngine(cfg, 40, 2, seed=1)
    cpu = GuardedEngine(cfg, 40, 2, device="cpu", params=_cpu_copy(gpu.params))
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, size=(2, 32)).astype(np.int64)
    errs, scale = [], 0.0
    with torch.inference_mode():
        lg, cg = gpu._prefill(gpu.params, torch.from_numpy(prompts).to(DEVICE))
        lc, cc = cpu._prefill(cpu.params, torch.from_numpy(prompts))
        errs.append(float((lg.cpu() - lc).abs().max()))
        scale = float(lc.abs().max())
        tok = torch.argmax(lc, -1)
        for t in range(2):
            lg, cg = gpu._decode_logits(gpu.params, cg, tok.to(DEVICE), 32 + t)
            lc, cc = cpu._decode_logits(cpu.params, cc, tok, 32 + t)
            errs.append(float((lg.cpu() - lc).abs().max()))
            tok = torch.argmax(lc, -1)
    print(f"olmo-1b 2 layers bf16, card vs CPU: logits max_abs_err {errs} at "
          f"|logit| <= {scale:.3g} (tol 0.25)")
    check(max(errs) <= 0.25, "full-width logits: card and CPU differ")


def check_tiny_training_against_cpu(arch: str = "olmo-1b") -> None:
    """Tiny ``arch`` (f32), 2 train steps on ``cuda_fused`` with the fused
    second moment, on the card (kernels) and on the CPU (plain versions),
    from the same weights and batches (a vision arch with its gates at 0.5
    and one context on both). Loss within 1e-3 (the token sum
    rounds each per-token loss to bf16; one of them a few ulps apart can
    round the other way: 2^-8 x ~6 / 32 tokens), grad norm within 1e-3
    relative (the same roundings of intermediates in f32 math summed in
    other orders; one bf16 rounding of a p may flip), parameters within 1e-5
    (the fused second moment's update is smooth in the gradients: lr x
    relative gradient error). For MLA the parameters are held as its CPU
    test holds them against the reference (``tests/test_torch_mla.py``):
    all but 0.1% within 1e-5 and every one within 1e-4 -- its chunked
    attention rounds q, k, v and p to bf16 in the forward and again in the
    recompute of the backward, and a flip there moves single elements'
    gradients (card vs CPU in a first run: 1.72e-5 at most)."""
    import torch

    from repro_torch import reduce as R
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import build

    cfg = get_arch(arch, tiny=True)
    dp_tol = 1e-4 if cfg.mla is not None else 1e-5
    tcfg = TrainConfig(total_steps=2, warmup_steps=1, fused_second_moment=True)
    gparams, gopt, gstep = build(cfg, tcfg, DEVICE)
    open_gates(gparams)
    cparams, copt, cstep = build(cfg, tcfg, "cpu", params=_cpu_copy(gparams))
    data = SyntheticLM(cfg.vocab_size, 16, 2, seed=3, n_codebooks=cfg.n_codebooks)
    ctx = {}
    if cfg.n_img_tokens:
        ctx = {"image_embeds": torch.randn((2, cfg.n_img_tokens, cfg.d_model),
                                           generator=torch.Generator().manual_seed(3))}
    for step in (1, 2):
        tokens = torch.from_numpy(data.next()["tokens"])
        gparams, gopt, gm = gstep(gparams, gopt, {"tokens": tokens.to(DEVICE),
                                                  **{k: v.to(DEVICE) for k, v in ctx.items()}})
        cparams, copt, cm = cstep(cparams, copt, {"tokens": tokens, **ctx})
        diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().reshape(-1)
                           for a, b in zip(R.tree_leaves(gparams), R.tree_leaves(cparams))])
        dp, over = float(diffs.max()), int((diffs > 1e-5).sum())
        dl = abs(float(gm["loss"]) - float(cm["loss"]))
        dg = abs(float(gm["grad_norm"]) - float(cm["grad_norm"])) / float(cm["grad_norm"])
        print(f"tiny {arch} training step {step}, card vs CPU: loss {float(gm['loss']):.6f} vs "
              f"{float(cm['loss']):.6f} (|d| {dl:.3g}, tol 1e-3), grad norm rel. diff {dg:.3g} "
              f"(tol 1e-3), params max |d| {dp:.3g} (tol {dp_tol:g}), {over} of "
              f"{diffs.numel()} past 1e-5 (tol {'0.1%' if cfg.mla is not None else 'none'})")
        check(dl <= 1e-3 and dg <= 1e-3 and dp <= dp_tol
              and over <= (1e-3 * diffs.numel() if cfg.mla is not None else 0),
              f"tiny {arch} training: card and CPU differ")


def check_full_width_training_against_cpu() -> None:
    """Full-width olmo-1b cut to 2 layers, bf16: the step-1 loss and
    gradient norm (the clip statistic's launch) on the card against the CPU
    from the same weights and batch (1 x 32 tokens). Tolerance: loss 0.05,
    grad norm 5% relative -- the matmuls are bf16 in both directions on
    both sides, every activation and gradient element rounded at 2^-9
    relative in other orders (the serving check sees logits 0.035 apart)."""
    import torch

    from repro_torch import optim
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_grads_fn
    from repro_torch.launch.train import build

    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=2)
    tcfg = TrainConfig()
    gparams, _, _ = build(cfg, tcfg, DEVICE)
    cparams, _, _ = build(cfg, tcfg, "cpu", params=_cpu_copy(gparams))
    tokens = torch.from_numpy(SyntheticLM(cfg.vocab_size, 32, 1, seed=1).next()["tokens"])
    outs = []
    for params, dev in ((gparams, DEVICE), (cparams, "cpu")):
        grads, loss = make_grads_fn(cfg, tcfg)(params, {"tokens": tokens.to(dev)})
        gnorm, _ = optim.global_norm_and_clip(grads, 1.0, backend="cuda_fused")
        outs.append((float(loss), float(gnorm)))
    (lg, gg), (lc, gc) = outs
    print(f"olmo-1b 2 layers bf16 training step, card vs CPU: loss {lg:.5f} vs {lc:.5f} "
          f"(tol 0.05), grad norm {gg:.5g} vs {gc:.5g} (tol 5% relative)")
    check(abs(lg - lc) <= 0.05 and abs(gg - gc) <= 0.05 * gc,
          "full-width training step: card and CPU differ")


def fit_checked(what: str, cfg, guard: bool, fn):
    """``fn()``, a training run through the CLI, with the device's peak
    memory read around it: the fit check's model of the step
    (``launch.train.train_step_peak_bytes``, guarded or not) plus the
    activation reserve must hold the peak above what was allocated before;
    the two are printed side by side. Returns ``(fn's result, that peak in
    bytes)``."""
    import gc

    import torch

    from repro_torch.configs import TrainConfig
    from repro_torch.launch import train as train_cli

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    peak = torch.cuda.max_memory_allocated() - base
    model = train_cli.train_step_peak_bytes(cfg, TrainConfig(), guard=guard)
    reserve = train_cli.ACTIVATION_RESERVE_BYTES
    print(f"fit, {what} ({cfg.n_layers} layers): measured peak {peak / 1e9:.2f} GB (above the "
          f"{base / 1e9:.2f} GB held before); the check's model {model / 1e9:.2f} GB + "
          f"{reserve / 1e9:.0f} GB reserve = {(model + reserve) / 1e9:.2f} GB; the peak past "
          f"the model {(peak - model) / 1e9:+.2f} GB")
    check(peak <= model + reserve,
          f"{what}: the training step's peak is past the fit check's model and reserve")
    return out, peak


def train_full_width(arch: str = "olmo-1b", guarded_steps: int = 0,
                     n_layers: int | None = None) -> dict:
    """Full-width ``arch`` (its published depth, or ``n_layers``), batch 4 x
    seq 512, 3 AdamW steps through the training CLI's ``main``
    (``--reduce-backend cuda_fused``), every kernel
    launch counted and held to ``train_launches_per_step``; with
    ``guarded_steps``, that many steps through ``main --guard`` after it,
    counted the same way; then steps of a fresh model profiled. Returns
    the launch counts (the guarded run's under "guarded") and the profile."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_cli

    cfg = get_arch(arch)
    if n_layers is not None:
        print(f"{arch} training: depth cut to {n_layers} of {cfg.n_layers} layers, full width")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    argv = ["--arch", arch, "--reduce-backend", "cuda_fused", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--log-every", "1"]
    per_step = train_launches_per_step(cfg)
    runs = {"plain": ([], TRAIN_STEPS)}
    if guarded_steps:
        runs["guarded"] = (["--guard"], guarded_steps)
    out = {}
    for name, (extra, steps) in runs.items():
        t0 = time.perf_counter()
        (losses, launches), _ = fit_checked(
            f"{arch} {name}", cfg, name == "guarded",
            lambda: counted_run(
                lambda: train_cli.main(argv + extra + ["--steps", str(steps)], cfg=cfg)))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"{arch} {name}: trained {steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
              f"{wall:.2f} s (initialisation included); losses {losses}; peak device memory "
              f"{peak:.2f} GB; launches {launches}")
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"{arch} {name}: non-finite training loss")
        for k, n in per_step.items():
            check(launches[k] == n * steps,
                  f"{arch} {name} training: {k}: {launches[k]} launches, expected {n * steps}")
        out[name] = dict(launches, peak_gb=peak)
    gc.collect()
    torch.cuda.empty_cache()
    params, opt, step_fn = train_cli.build(cfg, TrainConfig(total_steps=10, warmup_steps=1),
                                           DEVICE)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=1,
                       n_codebooks=cfg.n_codebooks)
    batches = [{"tokens": torch.from_numpy(data.next()["tokens"]).to(DEVICE)} for _ in range(4)]
    if cfg.n_img_tokens:  # the CLI's context: one synthetic image a sequence
        from repro_torch.models.frontends import synth_image_embeds

        ctx = synth_image_embeds(torch.Generator(device=DEVICE).manual_seed(1), TRAIN_BATCH,
                                 cfg.n_img_tokens, cfg.d_model, torch.bfloat16, DEVICE)
        for batch in batches:
            batch["image_embeds"] = ctx
    aux = None
    if cfg.moe is not None:
        from repro_torch.models.model import forward_hidden

        with torch.no_grad():
            _, aux = forward_hidden(params, cfg, batches[0]["tokens"][:, :-1])
        print(f"{arch}: the aux term (moe_aux + moe_z over {cfg.n_layers} layers) on a batch of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}: {float(aux):.6g}")
        check(bool(torch.isfinite(aux)) and float(aux) != 0.0,
              f"{arch}: the aux term is not finite and non-zero")
    prof = profile_train_step(cfg, step_fn, params, opt, batches, what=f"{arch} train step")
    if aux is not None:
        prof["aux"] = float(aux)
    del params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    launches = out.pop("plain")
    launches["guarded"] = out.get("guarded")
    return launches, prof


def profile_clip_statistic(arch: str, olmo_k4_ms: float, n_layers: int | None = None) -> dict:
    """The guarded clip statistic of full-width ``arch`` on the card: the
    norm, clip coefficient and census of seeded gradients of its parameter
    shapes (bf16), through ``optim.global_norm_and_clip(census=True)`` on
    cuda_fused. Past 128 leaves it takes the reference's route: every leaf
    squared at f32 and packed, one K8 launch over the pack, and the census
    counted on the host, leaf by leaf. Prints the pack's bytes, the launches,
    the device time of the whole statistic and of its pieces (profiler),
    beside olmo-1b's one-launch K4 at its training shape (``olmo_k4_ms``).
    Also holds K8 against its plain version on the pack's segments. Up to
    128 leaves the statistic is one K4 launch: its device time is printed
    and returned without K8's figures."""
    import gc

    import torch

    from repro_torch import optim
    from repro_torch import reduce as R
    from repro_torch.configs import get_arch
    from repro_torch.kernels.mma_reduce import mma_sum_segments, mma_sum_segments_plain
    from repro_torch.launch.train import param_leaves
    from repro_torch.models import init_params

    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    with torch.no_grad():
        grads = init_params(cfg, gen, DEVICE)
    leaves = R.tree_leaves(grads)
    n = sum(t.numel() for t in leaves)
    check(len(leaves) == param_leaves(cfg), f"{arch}: leaf count")
    def statistic():
        return optim.global_norm_and_clip(grads, 1.0, backend="cuda_fused", census=True)

    (gnorm, clip, counts), launches = counted_run(statistic)
    launches = {k: v for k, v in launches.items() if v}
    exact = float(sum(float(t.double().square().sum()) for t in leaves)) ** 0.5
    rel = abs(float(gnorm) - exact) / exact
    expected = {k: v for k, v in clip_statistic_kernels(cfg).items() if v}
    parts = "mma_sum_parts" in expected
    route = ("one K4 launch, its census in the launch" if parts else
             f"pack {n * 4} bytes of f32 squares (peak {n * 8} bytes with the squared leaves), "
             f"host census {len(leaves)} passes")
    print(f"{arch} clip statistic: {len(leaves)} leaves, {n} values; route: {route}, launches "
          f"{launches}; gnorm {float(gnorm):.6g} vs f64 {exact:.6g} (rel {rel:.3g}, tol 1e-5), "
          f"clip {float(clip):.6g}, census total {float(counts[-1])}")
    check(launches == expected, f"{arch} clip statistic: launches {launches}, expected {expected}")
    check(rel <= 1e-5 and float(counts[-1]) == 0.0, f"{arch} clip statistic: off the f64 norm")
    if parts:
        busy_ms = device_ms(statistic, "parts_kernel", iters=5)
        print(f"{arch} clip statistic device time {busy_ms:.3f} ms ({timed_by(busy_ms)}; one "
              f"K4 launch and its epilogue) against olmo-1b's K4 {olmo_k4_ms:.3f} ms")
        del grads, leaves
        gc.collect()
        torch.cuda.empty_cache()
        return {"statistic_ms": busy_ms, "timed_by": timed_by(busy_ms), "n": n,
                "segments": param_leaves(cfg), "olmo_k4_ms": olmo_k4_ms}
    kernel = "::segments_kernel<"
    events = complete_events(statistic, {kernel: 1}, 1, f"the {arch} clip statistic")
    busy_ms = sum(us for _, us in events.values()) / 1e3
    k8_ms = sum(us for k, (_, us) in events.items() if kernel in k) / 1e3
    print(f"{arch} clip statistic device time {busy_ms:.3f} ms (K8 {k8_ms:.3f} ms, the pack "
          f"and the host census the rest) against olmo-1b's one-launch K4 {olmo_k4_ms:.3f} ms")
    for key, (count, us) in sorted(events.items(), key=lambda kv: kv[1][1], reverse=True)[:6]:
        print(f"    {us / 1e3:9.4f} ms  {count:5d}x  {key[:90]}")
    # K8 against its plain version at the pack's segments (f32 compute:
    # bitwise, the same CUDA-core adds in the same order)
    sizes = [t.numel() for t in leaves]
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + size)
    pack = torch.cat([t.reshape(-1).float().square() for t in leaves])
    del grads, leaves
    gc.collect()
    lanes = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    kw = dict(compute_dtype=torch.float32, num_lanes=lanes)
    got = mma_sum_segments(pack, offsets, **kw)
    want = mma_sum_segments_plain(pack, offsets, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"K8 at the {arch} clip statistic ({len(sizes)} segments, {n} f32): max_abs_err "
          f"{err:.3g} vs plain (tol 0: the same f32 adds in the same order)")
    check(torch.equal(got, want), f"K8 at the {arch} pack disagrees with its plain version")
    lens = torch.tensor(sizes, device=DEVICE)
    b8, by8 = bound_ms(n * 4 + len(sizes) * 4, core_flops=n)
    timed = {
        "max_abs_err": err, "segments": len(sizes), "n": n,
        "ms": device_ms(lambda: mma_sum_segments(pack, offsets, **kw), "segments_kernel",
                        iters=5),
        "plain_ms": time_ms(lambda: mma_sum_segments_plain(pack, offsets, **kw), iters=2,
                            warmup=1),
        "bound_ms": b8, "bound_by": by8,
        "library_ms": time_ms(lambda: torch.segment_reduce(pack, "sum", lengths=lens),
                              iters=5, warmup=1),
        "statistic_ms": busy_ms, "statistic_k8_ms": k8_ms, "olmo_k4_ms": olmo_k4_ms,
    }
    timed["timed_by"] = {k: timed_by(timed[k]) for k in ("ms", "plain_ms", "library_ms")}
    del pack, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return timed


def profile_train_step(cfg, step_fn, params, opt, batches, guard=None,
                       what="train step") -> dict:
    """Where a training step's time goes: wall time on the host clock
    (without the profiler) against the device's busy time (profiler: every
    kernel, memset and copy, from a session whose kernel counts match the
    step's launches), and the device items that take the most. With
    ``guard`` (a guard state) ``step_fn`` is a guarded step. Returns
    ``{"wall_ms", "busy_ms"}``."""
    import torch

    def run(batch):
        nonlocal params, opt, guard
        if guard is None:
            params, opt, _ = step_fn(params, opt, batch)
        else:
            params, opt, guard, _ = step_fn(params, opt, guard, batch)

    run(batches[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[1:3]:
        run(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    n = train_launches_per_step(cfg)
    expect = {"::row_norm_kernel<": n["layernorm_np"] + n["rmsnorm"],
              _attn_kernel(cfg): n["flash_attention"], "::ce_kernel<": n["cross_entropy"],
              "::fused_sum_kernel<": n["mma_sum_fused"], "::parts_kernel<": n["mma_sum_parts"],
              "::segments_kernel<": n["mma_sum_segments"]}
    events = complete_events(lambda: run(batches[3]), expect, 1, f"the {what}")
    busy_ms = sum(us for _, us in events.values()) / 1e3
    print(f"{what} (4 x 512 tokens): wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {max(0.0, 1.0 - busy_ms / wall_ms):.3f}")
    for key, (count, us) in sorted(events.items(), key=lambda kv: kv[1][1], reverse=True)[:10]:
        print(f"    {us / 1e3:9.4f} ms/step  {count:5d}x  {key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


# ------------------- guarded training, rollback, non-kernel route -------------------

# The non-kernel route against the kernel route, full-depth olmo-1b in bf16
# on 4 x 512 tokens: per-token losses within 0.25 and mean losses within
# 0.02. The routes round different intermediates to bf16 (K5a and K6 against
# the engine's row statistics and the chunked attention). Tiny olmo in bf16
# on the CPU (3 and 16 layers, 4 x 64 tokens, random weights) puts the two
# non-kernel routes' per-token losses at most 0.075 and their means at most
# 0.004 from the kernel route's (f32: 0.013 and 0.0003); the bounds here are
# about three and five times those.
NONKERNEL_TOK_TOL, NONKERNEL_MEAN_TOL = 0.25, 0.02


class _Tee:
    """stdout that is also kept: what a CLI printed, for the checks."""

    def __init__(self, out):
        import io

        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        return self.buf.write(text)

    def flush(self):
        self.out.flush()


def run_captured(fn):
    """``fn()`` with its standard output shown and kept: (result, text)."""
    import contextlib

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn()
    return out, tee.buf.getvalue()


def run_nonkernel_route() -> dict:
    """Full-depth olmo-1b (random weights) on 4 x 512 seeded tokens through
    ``models.forward`` and ``losses.lm_loss`` on three routes from the same
    weights: the kernels (K5a, K6, K7), and ``use_kernels=False`` with the
    paper's technique on (``mma_torch``) and off (``torch``). Mean losses,
    the largest per-token difference against the kernel route (tolerances
    above), and the forward's time per route (CUDA events, each route
    twice, in turns). The non-kernel
    routes launch no kernel of this repository: that is what they are for.
    Returns the kernel route's launches of one forward and its loss."""
    import torch

    from repro_torch import models
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import losses

    t_phase = time.time()
    cfg = get_arch("olmo-1b")
    params = models.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(4), DEVICE)
    tokens = torch.from_numpy(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                          seed=5).next()["tokens"]).to(DEVICE).long()
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    routes = {
        "kernels": cfg,
        "mma_torch": dataclasses.replace(cfg, use_kernels=False, mma_reductions=True),
        "torch": dataclasses.replace(cfg, use_kernels=False, mma_reductions=False),
    }
    per_tok, means, fwd_ms, launches = {}, {}, {}, {}
    with torch.inference_mode():
        for name, c in routes.items():
            def route(c=c):
                logits, aux = models.forward(params, c, inputs)
                loss, _ = losses.lm_loss(logits, labels, aux, c)
                return logits, loss, losses.cross_entropy_tokens(
                    logits, labels, mma=c.mma_reductions, use_kernels=c.use_kernels)

            (logits, loss, per_tok[name]), counts = counted_run(route)
            launches[name] = {k: v for k, v in counts.items() if v}
            means[name] = float(loss)
            check(logits.shape == (TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()), f"non-finite logits on route {name}")
            del logits
        # the routes timed in turns, each twice: kernels, mma_torch, torch,
        # torch, mma_torch, kernels
        for name in list(routes) + list(routes)[::-1]:
            fwd_ms.setdefault(name, []).append(
                time_ms(lambda: models.forward(params, routes[name], inputs), iters=3, warmup=1))
    diffs = {n: float((per_tok[n] - per_tok["kernels"]).abs().max()) for n in routes}
    print(f"olmo-1b full depth, 4 x {TRAIN_SEQ} tokens: mean loss kernels {means['kernels']:.5f}, "
          f"mma_torch {means['mma_torch']:.5f}, torch {means['torch']:.5f}; largest per-token "
          f"difference from the kernel route: mma_torch {diffs['mma_torch']:.4g}, torch "
          f"{diffs['torch']:.4g} (tol {NONKERNEL_TOK_TOL}; means tol {NONKERNEL_MEAN_TOL})")
    print(f"forward (CUDA events, two readings each, in turns): kernels {fwd_ms['kernels']} "
          f"ms, mma_torch {fwd_ms['mma_torch']} ms, torch {fwd_ms['torch']} ms; launches per "
          f"forward {launches}")
    for name in ("mma_torch", "torch"):
        check(diffs[name] <= NONKERNEL_TOK_TOL, f"route {name}: per-token losses differ")
        check(abs(means[name] - means["kernels"]) <= NONKERNEL_MEAN_TOL,
              f"route {name}: mean loss differs")
        check(not launches[name], f"route {name} launched kernels: {launches[name]}")
    check(launches["kernels"].get("layernorm_np") == 2 * cfg.n_layers + 1
          and launches["kernels"].get("flash_attention") == cfg.n_layers,
          f"kernel route launches {launches['kernels']}")
    print(f"non-kernel route phase: {time.time() - t_phase:.1f} s")
    return {"forward_ms": fwd_ms, "mean_loss": means, "max_tok_diff": diffs,
            "launches": launches["kernels"]}


GUARD_STEPS = 3  # the guarded CLI run: step 2 poisoned with NaN


def _tree_bits(tensors) -> list:
    import torch

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [t.detach().view(ints[t.element_size()]) for t in tensors]


def _bitwise_equal(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(_tree_bits(a),
                                                                       _tree_bits(b)))


def _state_tensors(params, opt) -> list:
    from repro_torch import reduce as R

    return R.tree_leaves(params) + [opt.step] + list(opt.m) + list(opt.v)


def run_guarded_training(plain_busy_ms: float) -> dict:
    """Full-width olmo-1b, batch 4 x seq 512, through the training CLI's
    ``main`` with ``--guard --reduce-backend cuda_fused`` and a
    ``ChaosMonkey`` that poisons step 2's gradients with NaN: the census
    sees it (nonfinite > 0), the step is skipped, the losses stay finite,
    and every guarded step launches K4 exactly once (the clip statistic and
    the census in one launch). Then, from one seeded state on the same
    batch: a clean guarded step equals a plain step bitwise (parameters,
    moments, step), and a NaN-poisoned guarded step leaves all of them
    bitwise unchanged with one K4 launch. Last, the guarded step's device
    time against the plain step's (``plain_busy_ms``, this run). Returns
    the CLI run's step-1 loss, grad norm and clip at full precision, which
    the data mesh's run of the same global batch is held against."""
    import torch

    from repro_torch import optim
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime import ChaosMonkey

    t_phase = time.time()
    cfg = get_arch("olmo-1b")
    step1 = {}
    real_make = train_cli.make_guarded_train_step

    def recording(*args, **kwargs):  # the CLI's step, its first call's metrics kept
        step = real_make(*args, **kwargs)

        def run(*a):
            out = step(*a)
            if not step1:
                step1.update(grad_norm=float(out[3]["grad_norm"]), clip=float(out[3]["clip"]))
            return out

        return run

    train_cli.make_guarded_train_step = recording
    try:
        ((losses, out), launches), _ = fit_checked(
            "olmo-1b guarded, NaN on step 2", cfg, True,
            lambda: counted_run(lambda: run_captured(lambda: train_cli.main([
                "--arch", "olmo-1b", "--guard", "--reduce-backend", "cuda_fused",
                "--steps", str(GUARD_STEPS), "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--log-every", "1"], chaos=ChaosMonkey(nan_steps=(2,))))))
    finally:
        train_cli.make_guarded_train_step = real_make
    skipped = [ln for ln in out.splitlines() if ln.startswith("guard: step 2 skipped")]
    nonfinite = float(skipped[0].split("nonfinite ")[1].split(",")[0]) if skipped else 0.0
    print(f"guarded CLI run: losses {losses}; step 2 skipped: {bool(skipped)}, census "
          f"nonfinite {nonfinite:.0f}; launches {launches}")
    check(len(losses) == GUARD_STEPS and all(map(math.isfinite, losses)),
          "guarded training: non-finite loss")
    check(bool(skipped) and nonfinite > 0, "guarded training: the NaN step was not skipped")
    check(out.count(" skipped (") == 1, "guarded training: a clean step was skipped")
    per_step = train_launches_per_step(cfg)
    for k, n in per_step.items():
        check(launches[k] == n * GUARD_STEPS,
              f"guarded training: {k}: {launches[k]} launches, expected {n * GUARD_STEPS}")

    tcfg = TrainConfig(total_steps=10, warmup_steps=1)
    pparams, popt, plain = train_cli.build(cfg, tcfg, DEVICE)
    gparams, gopt, guarded = train_cli.build(cfg, tcfg, DEVICE, guard=True)  # same seed
    guard = optim.init_guard_state(16, DEVICE)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=6)
    batches = [{"tokens": torch.from_numpy(data.next()["tokens"]).to(DEVICE)} for _ in range(5)]
    pparams, popt, pm = plain(pparams, popt, batches[0])
    (gparams, gopt, guard, gm), counts = counted_run(
        lambda: guarded(gparams, gopt, guard, batches[0]))
    k4_clean = counts["mma_sum_parts"]
    equal = _bitwise_equal(_state_tensors(gparams, gopt), _state_tensors(pparams, popt))
    print(f"clean guarded step vs plain step, same state and batch: loss {float(gm['loss'])!r} "
          f"vs {float(pm['loss'])!r}, skipped {float(gm['skipped'])}, parameters, moments and "
          f"step bitwise equal: {equal}; K4 launches {k4_clean}")
    check(equal and float(gm["skipped"]) == 0.0, "a clean guarded step differs from a plain step")
    check(k4_clean == 1, f"the guarded step launched K4 {k4_clean} times")
    del pparams, popt, plain
    torch.cuda.empty_cache()
    before = [t.detach().clone() for t in _state_tensors(gparams, gopt)]
    poisoned = dict(batches[1], chaos_scale=torch.full((1,), float("nan"), device=DEVICE))
    (gparams, gopt, guard, gm), counts = counted_run(
        lambda: guarded(gparams, gopt, guard, poisoned))
    k4_bad = counts["mma_sum_parts"]
    unchanged = _bitwise_equal(_state_tensors(gparams, gopt), before)
    print(f"NaN-poisoned guarded step: nonfinite {float(gm['nonfinite']):.0f}, skipped "
          f"{float(gm['skipped'])}, parameters, moments and step bitwise unchanged: "
          f"{unchanged}; K4 launches {k4_bad}")
    check(float(gm["nonfinite"]) > 0 and float(gm["skipped"]) == 1.0,
          "the poisoned guarded step was not skipped")
    check(unchanged, "a skipped guarded step changed the state")
    check(k4_bad == 1, f"the poisoned guarded step launched K4 {k4_bad} times")
    del before
    torch.cuda.empty_cache()
    prof = profile_train_step(cfg, guarded, gparams, gopt, batches[1:], guard=guard,
                              what="guarded train step")
    print(f"guarded step device busy {prof['busy_ms']:.3f} ms against the plain step's "
          f"{plain_busy_ms:.3f} ms (this run): {prof['busy_ms'] - plain_busy_ms:+.3f} ms")
    del gparams, gopt, guarded
    torch.cuda.empty_cache()
    print(f"guarded training phase: {time.time() - t_phase:.1f} s")
    return {"launches": launches, "busy_ms": prof["busy_ms"], "wall_ms": prof["wall_ms"],
            "plain_busy_ms": plain_busy_ms, "step1_loss": losses[0], "step1": step1}


DRILL_LAYERS, DRILL_STEPS = 2, 5  # NaN on steps 3, 4, 5; rollback to the step-0 anchor


def run_rollback_drill() -> dict:
    """The rollback drill: olmo-1b at full width cut to 2 layers (one
    commit ~2.4 GB: 237.5 M bf16 parameters and two f32 moments), batch 4 x
    seq 512, through the training CLI's ``main`` with ``--guard
    --ckpt-dir`` (a temporary directory under ``build/``, deleted after)
    ``--ckpt-every 5 --max-bad-steps 3`` and NaN on steps 3, 4 and 5.
    Steps 1 and 2 run clean, 3 to 5 are skipped, the run rolls back to the
    step-0 anchor and replays: the replayed steps 1 to 3 must give the
    first run's losses bitwise (step 3's poisoned attempt computed its loss
    before its skip, from the same state). Then step 5's shard is truncated:
    restoring it raises ``CheckpointCorruptionError`` and
    ``restore_latest_valid`` falls back to the anchor, whose state equals
    the seeded initial state bitwise. Prints each save's and restore's
    bytes and seconds (CRC32 of every leaf verified)."""
    import re
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointManager
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime import ChaosMonkey

    t_phase = time.time()
    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=DRILL_LAYERS)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="rollback_drill_", dir=os.path.join(ROOT, "build"))
    try:
        ((losses, out), launches), _ = fit_checked(
            "olmo-1b rollback drill", cfg, True,
            lambda: counted_run(lambda: run_captured(lambda: train_cli.main([
                "--arch", "olmo-1b", "--guard", "--reduce-backend", "cuda_fused",
                "--steps", str(DRILL_STEPS), "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--ckpt-dir", tmp, "--ckpt-every", "5", "--max-bad-steps", "3",
                "--log-every", "1"], cfg=cfg, chaos=ChaosMonkey(nan_steps=(3, 4, 5))))))
        rolled = re.findall(r"guard: rolled back to step (\d+) \(data step (\d+)\)", out)
        records = re.findall(r"checkpoint (save|restore) step (\d+): (\d+) bytes, (.*)", out)
        print(f"rollback drill: losses {losses}; rollbacks {rolled}; launches {launches}")
        check(rolled == [("0", "0")], f"rollback drill: rollbacks {rolled}, expected one to 0")
        check(len(losses) == 2 * DRILL_STEPS and all(map(math.isfinite, losses)),
              "rollback drill: missing or non-finite losses")
        replay = losses[DRILL_STEPS:DRILL_STEPS + 3]
        print(f"losses of steps 1-3 before the fault {losses[:3]}, after the rollback {replay}")
        check(replay == losses[:3],
              "rollback drill: the replay's losses differ from the first run's")
        check(launches["mma_sum_parts"] == 2 * DRILL_STEPS,
              f"rollback drill: {launches['mma_sum_parts']} K4 launches for "
              f"{2 * DRILL_STEPS} guarded steps")
        check([(op, st) for op, st, _, _ in records] ==
              [("save", "0"), ("restore", "0"), ("save", "5")],
              f"rollback drill: checkpoint operations {records}")
        shard = os.path.join(tmp, "step_00000005", "shard_00000.npz")
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) // 2)
        like_params, like_opt, _ = train_cli.build(cfg, TrainConfig(), DEVICE)
        cm = CheckpointManager(tmp)
        try:
            cm.restore(5, (like_params, like_opt))
            raised = False
        except CheckpointCorruptionError as e:
            raised = True
            print(f"the truncated step-5 shard: {e}")
        check(raised, "rollback drill: a truncated shard did not raise")
        (rparams, ropt), step = cm.restore_latest_valid((like_params, like_opt))
        fresh = _state_tensors(like_params, like_opt)
        anchor = _bitwise_equal(_state_tensors(rparams, ropt), fresh)
        print(f"restore_latest_valid fell back to step {step}; quarantined: "
              f"{sorted(n for n in os.listdir(tmp) if n.startswith('quarantine'))}; the "
              f"state equals the seeded initial state bitwise: {anchor}")
        check(step == 0 and anchor, "rollback drill: restore_latest_valid did not fall back")
        records += [("restore", str(r["step"]), str(r["bytes"]), f"{r['seconds']:.3f} s, CRC "
                     "verified") for r in cm.records]
        for op, st, nbytes, what in records:
            print(f"    {op} step {st}: {int(nbytes) / 1e9:.3f} GB, {what}")
        del like_params, like_opt, rparams, ropt, fresh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"rollback drill phase: {time.time() - t_phase:.1f} s")
    return {"launches": launches, "records": records}


# ----------------------------------- main ------------------------------------


# --------------------- the dense archs' shapes, the meter, autotune ---------------------

# internlm2-1.8b: vocabulary 92544, padded to 92672 (128 pad columns)
INTERNLM2_VOCAB, INTERNLM2_PADDED = 92544, 92672


def _sdpa_gqa(q, k, v):
    """PyTorch's attention on GQA operands: ``enable_gqa`` where this
    PyTorch has it, else the kv heads repeated."""
    import torch.nn.functional as F

    rep = q.shape[1] // k.shape[1]
    try:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=rep > 1)
    except TypeError:
        k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)


def _rmsnorm_case(gen, arch: str, rows: int, d: int) -> dict:
    """K5b at (rows, d) bf16 with a bf16 gamma against its plain version
    (1 bf16 ulp), timed beside its bound and ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.row_moments import plan_for, rmsnorm_plain

    rms_lib = getattr(F, "rms_norm", None)
    x = (torch.randn((rows, d), generator=gen, device=DEVICE) * 3 + 1).to(torch.bfloat16)
    gamma = (torch.rand((d,), generator=gen, device=DEVICE) + 0.5).to(torch.bfloat16)
    got, want = rmsnorm(x, gamma, 1e-6), rmsnorm_plain(x, gamma, 1e-6)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    print(f"K5b rmsnorm ({rows}, {d}) bf16 ({arch}): max_abs_err {err:.3g} vs plain "
          f"(tol: 1 bf16 ulp); route {plan_for(x, gamma).name}")
    check(bf16_ulp_ok(got, want), f"rmsnorm disagrees with its plain version at ({rows}, {d})")
    b, by = bound_ms(2 * x.numel() * 2 + d * 2, tensor_flops=x.numel() * 16,
                     core_flops=5 * x.numel())
    return {
        "max_abs_err": err,
        "ms": device_ms(lambda: rmsnorm(x, gamma, 1e-6), "row_norm_kernel"),
        "plain_ms": time_ms(lambda: rmsnorm_plain(x, gamma, 1e-6), iters=20),
        "bound_ms": b, "bound_by": by,
        "library_ms": (device_ms(lambda: rms_lib(x, (d,), gamma, 1e-6))
                       if rms_lib is not None else None),
        "norm_route": plan_for(x, gamma).name,
    }


def _attention_case(gen, label: str, b_: int, hq: int, hkv: int, s_: int, d: int,
                    dtype: str = "bfloat16") -> dict:
    """K6 causal at (b_, hq q / hkv kv heads, s_, d) in ``dtype`` (f32
    operands are rounded to bf16 by the kernel's producer, as the plain
    version rounds them) against its plain version (2 bf16 ulps of the
    output + 2e-3), timed beside its bound and PyTorch's attention on the
    same GQA operands; its call time by CUDA events around back-to-back
    wrapper calls. Heads past 128 wide run the wide variant
    (``attn_fwd_wide_kernel``)."""
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain

    dt = getattr(torch, dtype)
    q = (torch.randn((b_, hq, s_, d), generator=gen, device=DEVICE) * 0.5).to(dt)
    k = (torch.randn((b_, hkv, s_, d), generator=gen, device=DEVICE) * 0.5).to(dt)
    v = (torch.randn((b_, hkv, s_, d), generator=gen, device=DEVICE) * 0.5).to(dt)
    got, want = flash_attention(q, k, v, causal=True), flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    print(f"K6 flash_attention {label} ({b_}, {hq} q / {hkv} kv heads, {s_}, {d}) {dtype}: "
          f"max_abs_err {err:.3g} vs plain (tol: 2 bf16 ulps of the output)")
    check(bool(torch.all((got.float() - want.float()).abs()
                         <= 2.0**-6 * want.float().abs() + 2e-3)),
          f"flash_attention disagrees with its plain version at {label}")
    lib_err = float((_sdpa_gqa(q, k, v).float() - got.float()).abs().max())
    print(f"    against PyTorch's attention: max |d| {lib_err:.3g}")
    pairs = _causal_pairs(s_, s_, 0, None) * b_ * hq
    bb, by = bound_ms((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                      tensor_flops=4 * d * pairs, core_flops=pairs)
    kernel = "attn_fwd_wide_kernel" if d > 128 else "attn_fwd_kernel"
    return {
        "max_abs_err": err,
        "ms": device_ms(lambda: flash_attention(q, k, v, causal=True), kernel),
        "call_ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v), iters=5, warmup=1),
        "bound_ms": bb, "bound_by": by,
        "library_ms": device_ms(lambda: _sdpa_gqa(q, k, v)),
    }


def _cross_entropy_case(gen, arch: str, vocab: int, padded: int,
                        rows: int = TRAIN_BATCH * TRAIN_SEQ) -> dict:
    """K7 over (rows, padded) f32 logits (2048 rows: a training chunk), the
    pad columns at -1e30 as the chunked loss's head gives them, against its
    plain version (1e-3) and the same logits cut to the real columns
    (1e-6), timed beside its bound and ``F.cross_entropy``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cross_entropy
    from repro_torch.kernels.cross_entropy import cross_entropy_plain

    logits = torch.randn((rows, padded), generator=gen, device=DEVICE) * 3
    logits[:, vocab:] = -1e30
    labels = torch.randint(0, vocab, (rows,), generator=gen, device=DEVICE)
    got, want = cross_entropy(logits, labels), cross_entropy_plain(logits, labels)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    cut = cross_entropy(logits[:, :vocab].contiguous(), labels)
    d_cut = float((cut - got).abs().max())
    print(f"K7 cross_entropy ({rows}, {padded}) f32 ({arch}, {padded - vocab} pad columns, a "
          f"ragged last slice): max_abs_err {err:.3g} vs plain (tol 1e-3); cut to the "
          f"{vocab} real columns: max |d| {d_cut:.3g} (tol 1e-6)")
    check(err <= 1e-3 and bool(torch.isfinite(got).all()),
          f"cross_entropy disagrees with its plain version at the {arch} vocabulary")
    check(d_cut <= 1e-6, f"cross_entropy: padded and cut widths differ at the {arch} vocabulary")
    n = logits.numel()
    bc, byc = bound_ms(n * 4 + rows * 8, tensor_flops=16 * n, core_flops=4 * n)
    lab64 = labels.to(torch.int64)
    return {
        "max_abs_err": err,
        "ms": device_ms(lambda: cross_entropy(logits, labels), "::ce_kernel<"),
        "plain_ms": time_ms(lambda: cross_entropy_plain(logits, labels), iters=5, warmup=1),
        "bound_ms": bc, "bound_by": byc,
        "library_ms": device_ms(lambda: F.cross_entropy(logits, lab64, reduction="none")),
    }


def _print_cases(cases) -> None:
    for key, t in cases:
        lib = "-" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.2f}"
        call = f", call {t['call_ms'] * 1e3:.2f} us" if "call_ms" in t else ""
        print(f"{key}: device {t['ms'] * 1e3:.2f} us{call}, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"library {lib} us, bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}")


def check_dense_shapes(results: dict) -> None:
    """K5b, K6 and K7 at the shapes internlm2-1.8b and deepseek-7b give
    them, each against its plain version and timed beside its bound and its
    PyTorch call (the kernel and the PyTorch call by the profiler's device
    time; the plain version, many small kernels, by CUDA events around the
    call, which keeps the run's profiler sessions fewer): RMSNorm (bf16,
    gamma bf16) at the decode rows, the prefill rows and the training rows
    at d = 2048, and at the decode and prefill rows at d = 4096; attention
    at 16 query heads on 8 kv heads (GQA) for the prefill and the training
    shape, and 32 on 32 at deepseek's prefill; the cross-entropy over
    (2048, 92672) f32 logits, 128 pad columns at -1e30. Tolerances as
    ``check_norms``, ``check_attention`` and ``check_cross_entropy``. The
    figures go under the kernels' "dense_archs" and "internlm2" keys."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    norms = {}
    for arch, d, rows_all in (("internlm2", 2048, (SLOTS, SLOTS * PROMPT,
                                                   TRAIN_BATCH * TRAIN_SEQ)),
                              ("deepseek", 4096, (SLOTS, SLOTS * PROMPT))):
        for rows in rows_all:
            norms[f"{arch}_{rows}x{d}"] = _rmsnorm_case(gen, arch, rows, d)
    attn = {label: _attention_case(gen, label, *shape) for label, shape in (
        ("internlm2_train", (TRAIN_BATCH, 16, 8, TRAIN_SEQ, 128)),
        ("internlm2_prefill", (SLOTS, 16, 8, PROMPT, 128)),
        ("deepseek_prefill", (SLOTS, 32, 32, PROMPT, 128)))}
    ce = _cross_entropy_case(gen, "internlm2", INTERNLM2_VOCAB, INTERNLM2_PADDED)
    results["rmsnorm"]["dense_archs"] = norms
    results["flash_attention"]["dense_archs"] = attn
    results["cross_entropy"]["internlm2"] = ce
    _print_cases(list(norms.items()) + list(attn.items()) + [("internlm2 ce", ce)])


# ------------------------------- the MoE archs -------------------------------

GRANITE, DBRX = "granite-moe-1b-a400m", "dbrx-132b"
MOE_ARCHS = (GRANITE, DBRX)
# granite: vocabulary 49155, padded to 49408 (253 pad columns); dbrx: 100352
GRANITE_VOCAB, GRANITE_PADDED, DBRX_VOCAB = 49155, 49408, 100352
# dbrx-132b's depth cut: its 40 layers take 263 GB at bf16, more than one
# card; 2 layers with the embedding and the untied head take ~15.5 GB
DBRX_LAYERS = 2


def check_head_widths(results: dict, gen) -> None:
    """K6 at head widths off the multiples of 16 (the wrapper zero-pads q,
    k and v to the next one and keeps the first d columns): d = 8
    (dbrx-tiny's heads) and 24, 8 query heads on 2 kv heads, 130 queries
    (a ragged block), f32 and bf16, against its plain version (2 bf16 ulps
    + 2e-3); one launch a call, counted by the meter."""
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain

    errs = {}
    for d in (8, 24):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = ((torch.randn(shape, generator=gen, device=DEVICE) * 0.5).to(dtype)
                       for shape in ((2, 8, 130, d), (2, 2, 130, d), (2, 2, 130, d)))
            out, launches = counted_run(lambda: flash_attention(q, k, v))
            plain = flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = float((out.float() - plain.float()).abs().max())
            print(f"K6 flash_attention at head width {d} (padded to {16 * -(-d // 16)} inside "
                  f"the wrapper) {str(dtype)[6:]}: max_abs_err {err:.3g} vs plain (tol: 2 bf16 "
                  f"ulps + 2e-3); launches {launches['flash_attention']}")
            check(out.shape == q.shape and launches["flash_attention"] == 1,
                  f"flash_attention at d = {d}: shape or launches")
            check(bool(torch.all((out.float() - plain.float()).abs()
                                 <= 2.0**-6 * plain.float().abs() + 2e-3)),
                  f"flash_attention disagrees with its plain version at d = {d}")
            errs[f"d{d}_{str(dtype)[6:]}"] = err
    results["flash_attention"]["head_widths"] = errs


# K6's wide variant (heads past 128 wide, up to 256): b, hq, hkv, sq, skv,
# d, causal, window, q_offset. d = 136 and 200 are zero-padded to 144 and
# 208 inside the wrapper; 144 and 208 reach the kernel as they are, its
# tensor maps' inner extent, past which TMA reads zeros.
WIDE_HEAD_CASES = (
    (2, 16, 1, 256, 256, 256, True, None, 0),     # recurrentgemma's MQA, 16 q / 1 kv
    (2, 16, 1, 256, 256, 200, True, None, 0),
    (2, 16, 1, 256, 256, 136, True, None, 0),
    (2, 16, 1, 300, 300, 144, True, None, 0),     # d = 144: TMA zero-fills the columns past it
    (1, 16, 4, 64, 320, 256, True, 128, 256),     # GQA + window + q_offset
    (1, 8, 2, 130, 200, 200, False, None, 0),     # ragged, non-causal
    (1, 4, 2, 200, 200, 136, True, 64, 0),        # window
)
# recurrentgemma-9b's attention (16 q / 1 kv heads of 256): training at 4 x
# 512 and the serving prefill at 4 x 256
RG_HEADS, RG_KV, RG_D = 16, 1, 256


def check_wide_heads(results: dict, gen) -> None:
    """K6 at heads 136, 200 and 256 wide (the wide variant) against its
    plain version at f32, bf16 and f16 (2 bf16 ulps + 2e-3), one launch a
    call counted by the meter (no width up to 256 falls back to the plain
    version), and 264 refused; then timed at recurrentgemma-9b's shapes
    beside its bound and PyTorch's attention (``_attention_case``)."""
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain

    errs = {}
    for case in WIDE_HEAD_CASES:
        b, hq, hkv, sq, skv, d, causal, window, q_offset = case
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v = ((torch.randn(shape, generator=gen, device=DEVICE) * 0.5).to(dtype)
                       for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
            out, launches = counted_run(lambda: flash_attention(q, k, v, **kw))
            plain = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((out.float() - plain.float()).abs().max())
            check(out.shape == q.shape and launches["flash_attention"] == 1,
                  f"flash_attention at {case}: shape or launches")
            check(bool(torch.isfinite(out.float()).all()) and bool(torch.all(
                (out.float() - plain.float()).abs() <= 2.0**-6 * plain.float().abs() + 2e-3)),
                f"flash_attention disagrees with its plain version at {case} {dtype}")
            errs[f"{case}_{str(dtype)[6:]}"] = err
        print(f"K6 flash_attention, wide variant, {case}: max_abs_err f32 / bf16 / f16 "
              f"{[round(errs[f'{case}_{t}'], 6) for t in ('float32', 'bfloat16', 'float16')]} "
              "vs plain (tol 2 bf16 ulps + 2e-3); one launch a call")
    try:
        q = torch.zeros((1, 1, 8, 264), device=DEVICE)
        flash_attention(q, q, q)
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"K6 at heads 264 wide: refused: {refused}")
    check(refused is not None, "flash_attention took heads past 256 wide")
    wide = {"max_abs_err": max(errs.values()), "errs": errs, "refused_264": refused,
            "source": "src/repro_torch/kernels/csrc/flash_attention_wide.cu"}
    for label, s_ in (("recurrentgemma training", TRAIN_SEQ), ("recurrentgemma prefill",
                                                               PROMPT)):
        wide[label.split()[1]] = _attention_case(gen, label, 4, RG_HEADS, RG_KV, s_, RG_D)
    _print_cases([(f"K6 wide, recurrentgemma {k}", v) for k, v in wide.items()
                  if k in ("training", "prefill")])
    results["flash_attention"]["wide"] = wide


def _logit_stat_case(gen, vocab: int, books: int = 0) -> dict:
    """K4 as the guarded logit statistic over the public logits of the
    serving slots, (SLOTS, 1, vocab) f32 (with ``books`` codebook streams
    (SLOTS, 1, books, vocab): a slot's streams are one part), with its
    census: against its plain version (1e-6 x mass, counts exact), timed
    beside its bound and a PyTorch sum of squares a slot."""
    import torch

    from repro_torch.kernels import mma_sum_parts
    from repro_torch.kernels.mma_reduce import mma_sum_parts_plain

    shape = (SLOTS, 1, books, vocab) if books else (SLOTS, 1, vocab)
    logits = torch.randn(shape, generator=gen, device=DEVICE) * 3
    parts = [logits[i] for i in range(SLOTS)]
    chains = ((),)

    def k4():
        return mma_sum_parts(parts, prologue="square", total_chains=chains, census=True)

    out = k4()
    plain = mma_sum_parts_plain(parts, ("square",) * SLOTS, chains, True)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    mass = float(logits.square().sum())
    print(f"K4 mma_sum_parts {' x '.join(map(str, shape))} f32 (the logit statistic): "
          f"max_abs_err {err:.3g} "
          f"vs plain, mass {mass:.4g} (tol: 1e-6 x mass; counts exact)")
    check(torch.equal(out[SLOTS + 1:], plain[SLOTS + 1:]) and err <= 1e-6 * mass,
          f"mma_sum_parts disagrees with its plain version at {SLOTS} x {vocab}")
    b, by = bound_ms(logits.numel() * 4 + out.numel() * 4, core_flops=3 * logits.numel())
    return {
        "max_abs_err": err,
        "ms": device_ms(k4, "parts_kernel"),
        "plain_ms": time_ms(lambda: mma_sum_parts_plain(parts, ("square",) * SLOTS, chains,
                                                        True), iters=5, warmup=1),
        "bound_ms": b, "bound_by": by,
        "library_ms": device_ms(lambda: logits.reshape(SLOTS, -1).square().sum(-1)),
    }


def check_moe_shapes(results: dict) -> None:
    """The kernels at the shapes the MoE archs give them, each against its
    plain version and timed beside its bound and PyTorch call (as
    ``check_dense_shapes``): K6 at d = 8 and 24 (``check_head_widths``);
    K5b at d = 1024 (granite: the decode, prefill and training rows) and
    d = 6144 (dbrx: decode and prefill rows); K6 at granite's 16 query on
    8 kv heads of 64 for training and prefill, the training shape also at
    heads of 128 (what the kernel's zero column half costs at 64), and
    dbrx's 48 on 8 of 128 at prefill; K7 over granite's (2048, 49408) f32
    logits, 253 pad columns; K4 as the logit statistic over granite's and
    dbrx's public logits. The figures go under the kernels' "moe_archs"
    keys."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(14)
    check_head_widths(results, gen)
    norms = {f"granite_{rows}x1024": _rmsnorm_case(gen, "granite", rows, 1024)
             for rows in (SLOTS, SLOTS * PROMPT, TRAIN_BATCH * TRAIN_SEQ)}
    norms.update({f"dbrx_{rows}x6144": _rmsnorm_case(gen, "dbrx", rows, 6144)
                  for rows in (SLOTS, SLOTS * PROMPT)})
    attn = {label: _attention_case(gen, label, *shape) for label, shape in (
        ("granite_train_d64", (TRAIN_BATCH, 16, 8, TRAIN_SEQ, 64)),
        ("granite_train_at_d128", (TRAIN_BATCH, 16, 8, TRAIN_SEQ, 128)),
        ("granite_prefill_d64", (SLOTS, 16, 8, PROMPT, 64)),
        ("dbrx_prefill", (SLOTS, 48, 8, PROMPT, 128)))}
    ce = _cross_entropy_case(gen, "granite", GRANITE_VOCAB, GRANITE_PADDED)
    stat = {"granite": _logit_stat_case(gen, GRANITE_VOCAB),
            "dbrx": _logit_stat_case(gen, DBRX_VOCAB)}
    results["rmsnorm"]["moe_archs"] = norms
    results["flash_attention"]["moe_archs"] = attn
    results["cross_entropy"]["granite"] = ce
    results["mma_sum_parts"]["moe_archs"] = stat
    _print_cases(list(norms.items()) + list(attn.items()) + [("granite ce", ce)]
                 + [(f"{k} logit statistic", v) for k, v in stat.items()])


MINICPM, MAMBA = "minicpm3-4b", "mamba2-780m"
NEW_ARCHS = (MINICPM, MAMBA)
# minicpm3-4b: vocabulary 73448, padded to 73472; mamba2-780m: 50280 -> 50432
MINICPM_VOCAB, MINICPM_PADDED, MAMBA_VOCAB, MAMBA_PADDED = 73448, 73472, 50280, 50432
# minicpm3-4b trains at full width cut in depth: its full-depth state takes
# 85.2 GB before activations, more than one card; 16 layers take 27.6 GB
MINICPM_TRAIN_LAYERS = 16


def check_mla_ssm_shapes(results: dict) -> None:
    """The kernels at the shapes the MLA and SSM archs give them, against
    their plain versions and timed beside their bounds and PyTorch calls
    (as ``check_moe_shapes``): K6's wide variant (``check_wide_heads``),
    K5b at d = 2560 (minicpm3) and d = 1536 (mamba2) at the decode,
    prefill and training rows, K7 over their (2048, padded vocabulary) f32
    logits, K4 as the logit statistic over their public logits. Neither
    arch runs K6 (MLA takes the chunked attention, as the reference does;
    the SSM has none). The figures go under the kernels' "mla_ssm_archs"
    keys."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(15)
    check_wide_heads(results, gen)
    norms = {f"{arch}_{rows}x{d}": _rmsnorm_case(gen, arch, rows, d)
             for arch, d in (("minicpm3", 2560), ("mamba2", 1536))
             for rows in (SLOTS, SLOTS * PROMPT, TRAIN_BATCH * TRAIN_SEQ)}
    ce = {"minicpm3": _cross_entropy_case(gen, "minicpm3", MINICPM_VOCAB, MINICPM_PADDED),
          "mamba2": _cross_entropy_case(gen, "mamba2", MAMBA_VOCAB, MAMBA_PADDED)}
    stat = {"minicpm3": _logit_stat_case(gen, MINICPM_VOCAB),
            "mamba2": _logit_stat_case(gen, MAMBA_VOCAB)}
    results["rmsnorm"]["mla_ssm_archs"] = norms
    results["cross_entropy"]["mla_ssm_archs"] = ce
    results["mma_sum_parts"]["mla_ssm_archs"] = stat
    _print_cases(list(norms.items()) + [(f"{k} ce", v) for k, v in ce.items()]
                 + [(f"{k} logit statistic", v) for k, v in stat.items()])


def check_prefill_bitwise(eng, prompts) -> dict:
    """Two prefills of one wave give the same logits and the same caches,
    bitwise."""
    import numpy as np
    import torch

    from repro_torch import reduce as R

    packed = eng._pack_wave([np.asarray(p) for p in prompts])
    with torch.inference_mode():
        first, c1 = eng._prefill(eng.params, packed)
        second, c2 = eng._prefill(eng.params, packed)
    torch.cuda.synchronize()
    same = torch.equal(first, second) and all(
        torch.equal(a, b) for a, b in zip(R.tree_leaves(c1), R.tree_leaves(c2)))
    print(f"{eng.cfg.name}: two prefills of one wave, logits and caches bitwise equal: {same}")
    check(same, f"{eng.cfg.name}: two prefills differ")
    return {"prefill_bitwise_equal": same}


def check_retry(eng, prompts) -> dict:
    """A decode step re-issued from one committed state -- a clean
    attempt, a NaN-poisoned one, the clean one again -- gives the same
    tokens, census and new caches, bitwise, and leaves the committed
    recurrent caches bitwise as they were: the SSM's and the RG-LRU's conv
    windows and states are new tensors, never written in place
    (``models.ssm.ssm_decode``, ``models.rglru.rglru_decode``; a ring or KV
    cache is rewritten at its slot with the same values)."""
    import torch

    from repro_torch import reduce as R

    ones = [1.0] * SLOTS
    state, _, _ = eng.start_wave(prompts, ones, "cuda_fused")
    recurrent = [c for kind, c in zip(eng.cfg.pattern_layers, state["caches"]["layers"])
                 if kind in ("ssm", "rec")]
    committed = [t.clone() for t in R.tree_leaves(recurrent)]
    s1, tok1, cen1 = eng.decode(state, ones, "cuda_fused")
    _, _, bad = eng.decode(state, [float("nan")] + ones[1:], "cuda_fused")
    s2, tok2, cen2 = eng.decode(state, ones, "cuda_fused")
    torch.cuda.synchronize()
    same = ((tok1 == tok2).all() and (cen1 == cen2).all() and all(
        torch.equal(a, b) for a, b in zip(R.tree_leaves(s1["caches"]),
                                          R.tree_leaves(s2["caches"]))))
    kept = all(torch.equal(a, b) for a, b in zip(committed, R.tree_leaves(recurrent)))
    print(f"{eng.cfg.name}: a decode step retried from its committed state (after a poisoned "
          f"attempt, census {float(bad[0])}): tokens, census and caches bitwise the clean "
          f"step's: {bool(same)}; committed recurrent caches untouched: {kept}")
    check(bool(same) and kept and float(bad[0]) > 0,
          f"{eng.cfg.name}: a retried decode step differs from the clean one")
    return {"retry_bitwise_equal": bool(same), "committed_untouched": kept}


def run_fit_phase() -> dict:
    """The training CLI's repaired fit check on the card, for
    recurrentgemma-9b, whose AdamW temporaries of a 256 000-row embedding
    and head set its peak: the deepest whole-unit depth that
    ``check_fits_card`` accepts, unguarded and with ``--guard``; the next
    unit refused by the CLI before any allocation; then one step at that
    depth through ``main`` (one plain, one guarded), its peak beside the
    check's model and reserve (``fit_checked``)."""
    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.launch import train as train_cli

    full = get_arch(RG)
    out = {}
    for guard in (False, True):
        what = "guarded" if guard else "plain"
        layers = 0
        while layers + RG_UNIT <= full.n_layers:
            try:
                train_cli.check_fits_card(dataclasses.replace(full, n_layers=layers + RG_UNIT),
                                          TrainConfig(), torch.device(DEVICE), guard=guard)
            except ValueError:
                break
            layers += RG_UNIT
        check(0 < layers < full.n_layers, f"{RG} {what}: no whole unit fits, or every one")
        argv = ["--arch", RG, "--reduce-backend", "cuda_fused", "--batch", str(TRAIN_BATCH),
                "--seq", str(TRAIN_SEQ), "--steps", "1", "--log-every", "1"]
        argv += ["--guard"] * guard
        nxt = dataclasses.replace(full, n_layers=layers + RG_UNIT)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        try:
            train_cli.main(argv, cfg=nxt)
            code = None
        except SystemExit as e:
            code = e.code
        after = torch.cuda.memory_allocated()
        need = train_cli.train_step_peak_bytes(nxt, TrainConfig(), guard=guard)
        print(f"fit, {RG} {what}: {layers + RG_UNIT} layers (the step's {need / 1e9:.2f} GB) "
              f"refused with exit code {code}; device memory allocated before / after: {before} "
              f"/ {after}")
        check(code not in (None, 0) and after == before,
              f"{RG} {what} at {layers + RG_UNIT} layers was not refused before allocating")
        cfg = dataclasses.replace(full, n_layers=layers)
        losses, peak = fit_checked(f"{RG} {what}, the deepest unit accepted", cfg, guard,
                                   lambda: train_cli.main(argv, cfg=cfg))
        check(len(losses) == 1 and all(np.isfinite(losses)), f"{RG} {what}: non-finite loss")
        out[what] = {"layers": layers, "refused_layers": layers + RG_UNIT,
                     "peak_gb": peak / 1e9, "loss": losses[0], "model_gb": train_cli.
                     train_step_peak_bytes(cfg, TrainConfig(), guard=guard) / 1e9}
    return out


def check_full_depth_refused(arch: str) -> None:
    """The training CLI refuses ``arch`` at full depth (the step's bytes by
    ``launch.train.train_step_peak_bytes``, with the activation reserve past
    the card: minicpm3-4b 93.8 GB, recurrentgemma-9b and
    llama-3.2-vision-11b past 200 GB) before it allocates anything."""
    import torch

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.launch import train as train_cli

    cfg = get_arch(arch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        train_cli.main(["--arch", arch, "--steps", "1", "--batch", str(TRAIN_BATCH),
                        "--seq", str(TRAIN_SEQ)])
        code = None
    except SystemExit as e:
        code = e.code
    after = torch.cuda.memory_allocated()
    print(f"{arch} training at full depth ({cfg.n_layers} layers, the step's "
          f"{train_cli.train_step_peak_bytes(cfg, TrainConfig()) / 1e9:.2f} GB + "
          f"{train_cli.ACTIVATION_RESERVE_BYTES / 1e9:.0f} GB kept for activations, card "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB): refused with "
          f"exit code {code}; device memory allocated before / after: {before} / {after}")
    check(code not in (None, 0) and after == before,
          f"{arch}: full-depth training was not refused before allocating")


def record_routing(fn):
    """``fn()`` with every MoE layer's routing recorded (``models.moe.route``,
    in layer order): (fn's result, [Routing, ...])."""
    from repro_torch.models import moe as MOE

    real, seen = MOE.route, []

    def recording(p, x, cfg, **kwargs):
        r = real(p, x, cfg, **kwargs)
        seen.append(r)
        return r

    MOE.route = recording
    try:
        out = fn()
    finally:
        MOE.route = real
    return out, seen


def drop_fractions(routes) -> list:
    """Each layer's ``moe_drop_frac``: the share of routed pairs past their
    expert's capacity."""
    return [1.0 - float(r.keep.sum()) / r.keep.numel() for r in routes]


def check_moe_prefill(eng, prompts) -> dict:
    """Two prefills of the same wave give the same logits, bitwise (the
    gather combine adds each token's expert outputs in a fixed order), and
    route the same; each layer's drop fraction at the prefill."""
    import numpy as np
    import torch

    packed = eng._pack_wave([np.asarray(p) for p in prompts])
    with torch.inference_mode():
        (first, _), routes = record_routing(lambda: eng._prefill(eng.params, packed))
        (second, _), again = record_routing(lambda: eng._prefill(eng.params, packed))
    torch.cuda.synchronize()
    same = torch.equal(first, second)
    same_routes = all(torch.equal(a.slot_token, b.slot_token) for a, b in zip(routes, again))
    drops = drop_fractions(routes)
    print(f"{eng.cfg.name}: two prefills of one wave, logits bitwise equal: {same}; routing "
          f"equal: {same_routes}; moe_drop_frac at the prefill (capacity "
          f"{routes[0].slot_token.shape[-1]} slots an expert): mean {np.mean(drops):.4f}, min "
          f"{min(drops):.4f}, max {max(drops):.4f} over {len(drops)} layers")
    check(same and same_routes, f"{eng.cfg.name}: two prefills differ")
    return {"prefill_bitwise_equal": same, "drop_frac_mean": float(np.mean(drops)),
            "drop_frac_max": max(drops)}


def check_dbrx_refused() -> None:
    """The serving entry refuses full-depth dbrx-132b (263 GB at bf16)
    before it allocates anything."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import GuardedEngine, serve_state_bytes

    cfg = get_arch(DBRX)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        GuardedEngine(cfg, PROMPT + MAX_NEW + 1, SLOTS, seed=0)
        message = None
    except ValueError as e:
        message = str(e)
    after = torch.cuda.memory_allocated()
    print(f"{DBRX} at full depth ({cfg.n_layers} layers, "
          f"{serve_state_bytes(cfg, SLOTS, PROMPT + MAX_NEW + 1) / 1e9:.1f} GB): refused: "
          f"{message}; device memory allocated before / after: {before} / {after}")
    check(message is not None and "sharded over more cards" in message
          and after == before, f"{DBRX}: full depth was not refused before allocating")


# ---------------- the RG-LRU hybrid and vision cross-attention ----------------

RG, VISION = "recurrentgemma-9b", "llama-3.2-vision-11b"
RG_VISION_ARCHS = (RG, VISION)
# both vocabularies are multiples of 256: no pad columns
RG_VOCAB, VISION_VOCAB = 256000, 128256
RG_WINDOW = 2048
# the ring case: prompts past the window, so the prefill takes the ring
# branch and the decode steps wrap the ring
RING_PROMPT = RG_WINDOW + 256
# training cut in depth to whole pattern units that fit one card with at
# most 128 leaves (one K4 for the clip statistic), plain and guarded:
# recurrentgemma 1 unit (36 leaves; its step 67.0 GB, 75.4 guarded, by
# ``launch.train.train_step_peak_bytes``), llama-3.2-vision 2 units (95;
# 60.0 / 64.2 GB). The fit phase (``run_fit_phase``) takes recurrentgemma
# to the deepest unit the check accepts.
RG_TRAIN_LAYERS, VISION_TRAIN_LAYERS = 3, 10
RG_UNIT = 3  # recurrentgemma-9b's pattern: rec, rec, local_attn
# the cross-attention gates are zero at init (a closed gate adds nothing);
# the vision checks open them to this
OPEN_GATE = 0.5
# Decode logits against a teacher-forcing forward over the same tokens on
# the card at full width: |d| within these. The two sides multiply in other
# shapes (GEMV against GEMM), attend on other routes (the decode's
# bf16-rounded torch products against K6) and, for the RG-LRU, step the
# recurrence against its log-depth scan. At bf16 every GEMM rounds its
# output to bf16 in another order, and the gap read 0.14-0.16 on
# recurrentgemma on an H100 against 0.36 for a ring filled at
# slot pos: too near for a limit with margin. So the planted faults are
# held at f32 (the same archs at full width, 38-39 GB of f32 weights),
# where only attention's bf16-rounded operands separate the two sides.
DECODE_LOGIT_TOL = 0.5
F32_DECODE_LOGIT_TOL = 0.05


# K6's wide variant at recurrentgemma's window: b, hq, hkv, sq, skv, d,
# window, q_offset, all causal. Past the window whole key blocks fall out of
# it: the block-skip conditions of ``flash_attention_wide.cu`` are first
# exercised there. The last case is the decode-adjacent form: queries at
# the end of a long stream, placed by q_offset.
WINDOW_CASES = (
    (1, RG_HEADS, RG_KV, RING_PROMPT, RING_PROMPT, RG_D, RG_WINDOW, 0),
    (2, RG_HEADS, RG_KV, 64, RING_PROMPT, RG_D, RG_WINDOW, RING_PROMPT - 64),
    (1, RG_HEADS, RG_KV, 2200, 2200, RG_D, RG_WINDOW, 0),  # past the window, 2200 % 128 != 0
)


def _sdpa_window(q, k, v, window: int, q_offset: int = 0):
    """PyTorch's attention with the causal window as a boolean mask."""
    import torch
    import torch.nn.functional as F

    sq, skv = q.shape[2], k.shape[2]
    qp = q_offset + torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = (kp <= qp) & (qp - kp < window)
    rep = q.shape[1] // k.shape[1]
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=rep > 1)
    except TypeError:
        k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def _window_attention_case(gen, b_: int, s_: int, timed: bool, hq: int = RG_HEADS) -> dict:
    """K6's wide variant at recurrentgemma's heads (16 q / 1 kv x 256; ``hq``
    query heads: a model rank's 8 in the sharded ring prefill), causal with
    the window of 2048 over ``s_`` tokens, bf16: against its plain version
    (2 bf16 ulps + 2e-3), one launch; with ``timed`` its device and call
    times beside its bound (the pairs the window leaves) and PyTorch's
    attention with the window as a mask."""
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain

    q = (torch.randn((b_, hq, s_, RG_D), generator=gen, device=DEVICE) * 0.5).bfloat16()
    k = (torch.randn((b_, RG_KV, s_, RG_D), generator=gen, device=DEVICE) * 0.5).bfloat16()
    v = (torch.randn((b_, RG_KV, s_, RG_D), generator=gen, device=DEVICE) * 0.5).bfloat16()
    kw = dict(causal=True, window=RG_WINDOW)
    got, launches = counted_run(lambda: flash_attention(q, k, v, **kw))
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(launches["flash_attention"] == 1 and bool(torch.all(
        (got.float() - want.float()).abs() <= 2.0**-6 * want.float().abs() + 2e-3)),
        f"flash_attention's wide variant disagrees with its plain version at {b_} x {s_}")
    out = {"max_abs_err": err}
    if timed:
        pairs = _causal_pairs(s_, s_, 0, RG_WINDOW) * b_ * hq
        bb, by = bound_ms((2 * q.numel() + 2 * k.numel()) * 2, tensor_flops=4 * RG_D * pairs,
                          core_flops=pairs)
        out.update({
            "ms": device_ms(lambda: flash_attention(q, k, v, **kw), "attn_fwd_wide_kernel"),
            "call_ms": time_ms(lambda: flash_attention(q, k, v, **kw), iters=20),
            "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=2,
                                warmup=1),
            "bound_ms": bb, "bound_by": by,
            "library_ms": device_ms(lambda: _sdpa_window(q, k, v, RG_WINDOW)),
        })
    return out


def check_window_attention(results: dict, gen) -> None:
    """K6's wide variant at recurrentgemma's window (``WINDOW_CASES``, f32,
    bf16 and f16; 2 bf16 ulps + 2e-3 of the plain version, one launch a
    call), then timed at the ring case's prefill (4 x 2304 tokens, window
    2048) and at the serving prefill's 1 x 2304."""
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain

    errs = {}
    for case in WINDOW_CASES:
        b, hq, hkv, sq, skv, d, window, q_offset = case
        kw = dict(causal=True, window=window, q_offset=q_offset)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v = ((torch.randn(shape, generator=gen, device=DEVICE) * 0.5).to(dtype)
                       for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
            out, launches = counted_run(lambda: flash_attention(q, k, v, **kw))
            plain = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((out.float() - plain.float()).abs().max())
            check(out.shape == q.shape and launches["flash_attention"] == 1,
                  f"flash_attention at {case}: shape or launches")
            check(bool(torch.isfinite(out.float()).all()) and bool(torch.all(
                (out.float() - plain.float()).abs() <= 2.0**-6 * plain.float().abs() + 2e-3)),
                f"flash_attention disagrees with its plain version at {case} {dtype}")
            errs[f"{case}_{str(dtype)[6:]}"] = err
        print(f"K6 flash_attention, wide variant, window {window}, {case}: max_abs_err f32 / "
              f"bf16 / f16 {[round(errs[f'{case}_{t}'], 6) for t in ('float32', 'bfloat16', 'float16')]} "
              "vs plain (tol 2 bf16 ulps + 2e-3); one launch a call")
    ring = _window_attention_case(gen, SLOTS, RING_PROMPT, timed=True)
    # a model rank's half of the heads: the sharded serving phase's ring prefill
    half = _window_attention_case(gen, SLOTS, RING_PROMPT, timed=True, hq=RG_HEADS // 2)
    wide = results["flash_attention"]["wide"]
    wide["window_errs"] = errs
    wide["ring_prefill"], wide["ring_prefill_sharded"] = ring, half
    wide["max_abs_err"] = max([wide["max_abs_err"], ring["max_abs_err"], half["max_abs_err"]]
                              + list(errs.values()))
    _print_cases([(f"K6 wide, window {RG_WINDOW}, {SLOTS} x {RING_PROMPT}", ring),
                  (f"K6 wide, window {RG_WINDOW}, {SLOTS} x {RG_HEADS // 2}q/{RG_KV}kv x "
                   f"{RING_PROMPT} (a model rank's heads)", half)])


def check_rg_vision_shapes(results: dict) -> None:
    """The kernels at the shapes recurrentgemma-9b and llama-3.2-vision-11b
    give them, each against its plain version and timed beside its bound
    and PyTorch call (as ``check_moe_shapes``): K6's wide variant at the
    window (``check_window_attention``); K6 at vision's 32 query heads on
    8 kv heads of 128 for training and prefill; K5b at d = 4096 (both
    archs) at the decode, prefill and training rows; K7 over (2048,
    256000) and (2048, 128256) f32 logits (no pad columns); K4 as the
    logit statistic over 4 x 256000 and 4 x 128256. The figures go under
    the kernels' "rg_vision_archs" keys."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(16)
    check_window_attention(results, gen)
    norms = {f"d4096_{rows}x4096": _rmsnorm_case(gen, "recurrentgemma, llama-3.2-vision",
                                                 rows, 4096)
             for rows in (SLOTS, SLOTS * PROMPT, TRAIN_BATCH * TRAIN_SEQ)}
    attn = {label: _attention_case(gen, label, *shape) for label, shape in (
        ("vision_train", (TRAIN_BATCH, 32, 8, TRAIN_SEQ, 128)),
        ("vision_prefill", (SLOTS, 32, 8, PROMPT, 128)))}
    ce = {"recurrentgemma": _cross_entropy_case(gen, "recurrentgemma", RG_VOCAB, RG_VOCAB),
          "vision": _cross_entropy_case(gen, "llama-3.2-vision", VISION_VOCAB, VISION_VOCAB)}
    stat = {"recurrentgemma": _logit_stat_case(gen, RG_VOCAB),
            "vision": _logit_stat_case(gen, VISION_VOCAB)}
    results["rmsnorm"]["rg_vision_archs"] = norms
    results["flash_attention"]["rg_vision_archs"] = attn
    results["cross_entropy"]["rg_vision_archs"] = ce
    results["mma_sum_parts"]["rg_vision_archs"] = stat
    _print_cases(list(norms.items()) + list(attn.items())
                 + [(f"{k} ce", v) for k, v in ce.items()]
                 + [(f"{k} logit statistic", v) for k, v in stat.items()])


def teacher_forced_gap(eng, prompts, steps: int, seq=None, want=None):
    """Prefill ``prompts`` and decode ``steps - 1`` tokens (greedy, or the
    tokens of ``seq`` after the prompt), then a teacher-forcing forward
    over the same tokens on the card (the head applied at the ``steps``
    positions compared only), or ``want``, the forward's logits from an
    earlier call (a planted fault may sit in code the forward shares):
    ``(largest |decode logit - forward logit|, the token sequence, the
    decode's launches, its last caches, the forward's logits)``."""
    import numpy as np
    import torch

    from repro_torch.models.model import _head_public, forward_hidden

    cfg = eng.cfg
    packed = eng._pack_wave([np.asarray(p) for p in prompts])
    plen = packed.shape[1]

    def decode():
        with torch.inference_mode():
            logits, caches = eng._prefill(eng.params, packed)
            outs, toks = [logits], [torch.argmax(logits, -1)]
            for t in range(steps - 1):
                tok = toks[-1] if seq is None else seq[:, plen + t:plen + t + 1]
                logits, caches = eng._decode_logits(eng.params, caches, tok, plen + t)
                outs.append(logits)
                toks.append(torch.argmax(logits, -1))
            return torch.cat(outs, 1), torch.cat([packed] + toks[:-1], 1), caches

    (got, fed, caches), launches = counted_run(decode)
    if seq is None:
        seq = fed
    if want is None:
        with torch.inference_mode():
            h, _ = forward_hidden(eng.params, cfg, seq, eng.ctx)
            want = _head_public(eng.params, cfg, h[:, plen - 1:])
            del h
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
          f"{cfg.name}: decode logits not finite or of the wrong shape")
    return float((got - want).abs().max()), seq, launches, caches, want


def check_ring_case(eng, tol: float, plant: bool) -> dict:
    """recurrentgemma-9b at full width with prompts past its window: an
    engine on ``eng``'s weights with a ring of 2048 slots, 4 prompts of
    2304 tokens (the prefill takes the ring branch: each local layer keeps
    positions 256..2303, position p at slot p % 2048) and 16 greedy tokens
    (the decode steps evict the oldest keys), its decode logits against a
    teacher-forcing forward over the same 2319 tokens within ``tol``; the
    same at the serving prompt (256 tokens, no wrap) as the baseline; with
    ``plant``, a ring filled at slot pos (the first 2048 positions kept)
    must fail the limit. One K6 launch (the wide variant, with its window)
    a local layer in the prefill and none in a decode step, counted by the
    meter."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch.serve import GuardedEngine
    from repro_torch.models import attention as A

    cfg = eng.cfg
    rng = np.random.default_rng(26)
    ring_eng = GuardedEngine(cfg, RING_PROMPT + MAX_NEW + 1, SLOTS, params=eng.params)
    prompts = [rng.integers(0, cfg.vocab_size, size=(RING_PROMPT,)) for _ in range(SLOTS)]
    t0 = time.perf_counter()
    gap, seq, launches, caches, want = teacher_forced_gap(ring_eng, prompts, MAX_NEW)
    wall = time.perf_counter() - t0
    n_local = cfg.pattern_layers.count("local_attn")
    ring = [c for kind, c in zip(cfg.pattern_layers, caches["layers"]) if kind == "local_attn"]
    slots = ring[0]["slot_pos"].cpu()
    last = RING_PROMPT + MAX_NEW - 2  # the last decoded position
    expect = list(range(last - RG_WINDOW + 1, last + 1))
    check(ring[0]["k"].shape[1] == RG_WINDOW and sorted(slots.tolist()) == expect
          and all(int(p) % RG_WINDOW == i for i, p in enumerate(slots.tolist())),
          f"{cfg.name}: the ring does not hold the last {RG_WINDOW} positions at p % window")
    check(launches["flash_attention"] == n_local,
          f"{cfg.name} ring case: {launches['flash_attention']} K6 launches, expected {n_local}")
    fault = None
    if plant:
        with planted(A, "fill_kv_cache", _ring_filled_at_slot_pos):
            fault = teacher_forced_gap(ring_eng, prompts, MAX_NEW, seq=seq, want=want)[0]
    del ring_eng, caches, want
    gc.collect()
    base = teacher_forced_gap(eng, [p[:PROMPT] for p in prompts], MAX_NEW)[0]
    planted_note = "" if fault is None else (
        f"; with the ring filled at slot pos planted: {fault:.4g} (must exceed the tol)")
    print(f"{cfg.name} {cfg.dtype} ring case ({SLOTS} x {RING_PROMPT} prompt tokens, window "
          f"{RG_WINDOW}, {MAX_NEW} tokens decoded): decode vs teacher-forcing forward max |d| "
          f"{gap:.4g} (tol {tol}); at the serving prompt of {PROMPT} (no wrap) {base:.4g}"
          f"{planted_note}; ring slots hold positions {expect[0]}..{expect[-1]} at p % "
          f"{RG_WINDOW}; launches {launches}; {wall:.2f} s with the forward")
    check(gap <= tol and base <= tol, f"{cfg.name}: decode logits differ from the forward's")
    check(fault is None or fault > tol,
          f"{cfg.name}: the limit passes a ring filled at slot pos")
    torch.cuda.empty_cache()
    return {f"{cfg.dtype}_ring_gap": gap, f"{cfg.dtype}_unwrapped_gap": base,
            f"{cfg.dtype}_ring_fault_gap": fault, f"{cfg.dtype}_ring_launches": launches}


def check_vision_gated(eng, tol: float, plant: bool) -> dict:
    """llama-3.2-vision-11b at full width with its 8 cross-attention gates
    opened to 0.5: 4 prompts of 256 tokens and 16 greedy tokens against a
    teacher-forcing forward over the same tokens with the same context,
    within ``tol``; with ``plant``, the cross-attention's k and v taken
    from the next kv head must fail it. The gates are closed again after."""
    import numpy as np

    from repro_torch.models import attention as A

    cfg = eng.cfg
    rng = np.random.default_rng(27)
    prompts = [rng.integers(0, cfg.vocab_size, size=(PROMPT,)) for _ in range(SLOTS)]
    closed = teacher_forced_gap(eng, prompts, MAX_NEW)[0]
    open_gates(eng.params, OPEN_GATE)
    fault = None
    try:
        gap, seq, launches, _, want = teacher_forced_gap(eng, prompts, MAX_NEW)
        if plant:
            with planted(A, "cross_kv", _cross_kv_from_next_head):
                fault = teacher_forced_gap(eng, prompts, MAX_NEW, seq=seq, want=want)[0]
    finally:
        open_gates(eng.params, 0.0)
    n_attn = cfg.pattern_layers.count("attn")
    planted_note = "" if fault is None else (
        f"; with the cross-attention's k and v from the next kv head planted: {fault:.4g} "
        "(must exceed the tol)")
    print(f"{cfg.name} {cfg.dtype} with its gates at {OPEN_GATE} ({cfg.n_img_tokens} image "
          f"tokens a slot): decode vs teacher-forcing forward max |d| {gap:.4g} (tol {tol}; "
          f"gates closed {closed:.4g}){planted_note}; launches {launches}")
    check(launches["flash_attention"] == n_attn,
          f"{cfg.name}: {launches['flash_attention']} K6 launches, expected {n_attn}")
    check(gap <= tol and closed <= tol, f"{cfg.name}: decode logits differ from the forward's")
    check(fault is None or fault > tol,
          f"{cfg.name}: the limit passes a wrong kv-head mapping")
    return {f"{cfg.dtype}_gated_gap": gap, f"{cfg.dtype}_closed_gap": closed,
            f"{cfg.dtype}_gated_fault_gap": fault}


def check_at_f32(arch: str, check_fn) -> dict:
    """``check_fn(engine, F32_DECODE_LOGIT_TOL, plant=True)`` on ``arch`` at
    full width and depth with f32 weights (38-39 GB, seeded as the bf16
    engine's), the engine freed after."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import GuardedEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    eng = GuardedEngine(cfg, PROMPT + MAX_NEW + 1, SLOTS, seed=0)
    try:
        return check_fn(eng, F32_DECODE_LOGIT_TOL, plant=True)
    finally:
        del eng
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------ the audio arch ------------------------------

MUSICGEN = "musicgen-medium"
# 24 MHA heads of 64; vocabulary 2048 (a multiple of 256: no pad columns),
# 4 codebook streams; tiny musicgen's 64 columns are padded to 256
MUSICGEN_HEADS, MUSICGEN_D, MUSICGEN_VOCAB, MUSICGEN_BOOKS = 24, 64, 2048, 4
TINY_MUSICGEN_VOCAB, TINY_MUSICGEN_PADDED = 64, 256


def _ce_launch_slices(gen, rows: int, width: int) -> int:
    """K7's vocabulary slices a row block in one metered launch over (rows,
    width) f32 logits, read from the bytes the launch noted: past the
    logits, labels and losses they are the slices' (max, sum) partials, 16
    rows x 2 f32 a slice and row block, which one slice does not write."""
    import torch

    from repro_torch import reduce as R
    from repro_torch.kernels import common, cross_entropy
    from repro_torch.kernels.cross_entropy.ops import BLOCK_ROWS

    logits = torch.randn((rows, width), generator=gen, device=DEVICE)
    labels = torch.randint(0, width, (rows,), generator=gen, device=DEVICE)
    _, records = R.launch_records(cross_entropy, logits, labels)
    check(len(records) == 1 and records[0].route == "kernel",
          f"cross_entropy at {width} columns: one launch expected, got {records}")
    part = records[0].write_bytes - 4 * rows
    return 1 if part == 0 else part // (common.ceil_div(rows, BLOCK_ROWS) * BLOCK_ROWS * 2 * 4)


def check_audio_shapes(results: dict) -> None:
    """The kernels at the shapes musicgen-medium gives them, each against
    its plain version and timed beside its bound and PyTorch call (as
    ``check_moe_shapes``): K6 at 24 MHA heads of 64 (24 is no power of
    two) for the training step (4 x 512) and the serving prefill (4 x
    256); K7 over one training chunk's (8192, 2048) f32 logits (4 x 512
    tokens x 4 streams; one 2048-column slice a row block, so no merge
    across CTAs) and over tiny musicgen's (128, 256) with 192 pad columns;
    K4 as the logit statistic over 4 slots of (1, 4, 2048). K7's split
    count is read from its launches (``_ce_launch_slices``), at 4096 columns
    as well, where it must be 2. Its LayerNorm has no kernel (the engine's
    moments in torch). The figures go under the kernels' "musicgen" keys."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    attn = {label: _attention_case(gen, label, *shape) for label, shape in (
        ("musicgen_train", (TRAIN_BATCH, MUSICGEN_HEADS, MUSICGEN_HEADS, TRAIN_SEQ, MUSICGEN_D)),
        ("musicgen_prefill", (SLOTS, MUSICGEN_HEADS, MUSICGEN_HEADS, PROMPT, MUSICGEN_D)))}
    rows = TRAIN_BATCH * TRAIN_SEQ * MUSICGEN_BOOKS
    ce = {"musicgen": _cross_entropy_case(gen, MUSICGEN, MUSICGEN_VOCAB, MUSICGEN_VOCAB,
                                          rows=rows),
          "musicgen_tiny": _cross_entropy_case(gen, "musicgen-tiny", TINY_MUSICGEN_VOCAB,
                                               TINY_MUSICGEN_PADDED, rows=2 * 16 * 4)}
    slices = {width: _ce_launch_slices(gen, rows, width) for width in (
        MUSICGEN_VOCAB, TINY_MUSICGEN_PADDED, 2 * MUSICGEN_VOCAB)}
    print(f"K7's vocabulary split, read from its launches' partials: {slices[MUSICGEN_VOCAB]} "
          f"slice a row block at {MUSICGEN}'s {MUSICGEN_VOCAB} columns (no merge across CTAs), "
          f"{slices[TINY_MUSICGEN_PADDED]} at the tiny arch's {TINY_MUSICGEN_PADDED}; "
          f"{slices[2 * MUSICGEN_VOCAB]} at {2 * MUSICGEN_VOCAB} (must be 1, 1, 2)")
    check(slices == {MUSICGEN_VOCAB: 1, TINY_MUSICGEN_PADDED: 1, 2 * MUSICGEN_VOCAB: 2},
          f"K7's vocabulary split at musicgen's widths: {slices}")
    stat = {"musicgen": _logit_stat_case(gen, MUSICGEN_VOCAB, books=MUSICGEN_BOOKS)}
    results["flash_attention"]["musicgen"] = attn
    results["cross_entropy"]["musicgen"] = ce
    results["mma_sum_parts"]["musicgen"] = stat
    _print_cases(list(attn.items()) + [(f"{k} ce", v) for k, v in ce.items()]
                 + [(f"{k} logit statistic", v) for k, v in stat.items()])


# ------------------- the reference's examples as entry points -------------------

# train_100m at the reference's defaults: llama-110m, 300 steps of 8 x 512.
LLAMA_STEPS, LLAMA_BATCH, LLAMA_SEQ = 300, 8, 512
LLAMA_LOG_EVERY = 30


def check_llama_110m_shapes(results: dict) -> None:
    """The kernels at the shapes ``examples.train_100m`` gives them, each
    against its plain version and timed beside its bound and its PyTorch
    call: K6 at 8 x 12 MHA heads of 64 x 512 on f32 operands (the config's
    dtype; the kernel rounds them to bf16 as the reference's attention
    does), K7 over (4096, 32000) f32 (no pad columns: 32000 is a multiple
    of 256), and K4 as the clip statistic over llama-110m's 111 f32
    gradient leaves with the optimizer's fork (tolerance 1e-6 x the mass:
    f32 sums in another order; its device time by the profiler and its
    whole call by CUDA events: at 162 M values the host's work on the 111
    parts shows in the call), against ``get_total_norm``. The figures go
    under each kernel's "llama_110m" key."""
    import torch

    from repro_torch.examples.train_100m import CFG_100M as cfg
    from repro_torch.kernels import mma_sum_parts
    from repro_torch.kernels.mma_reduce import mma_sum_parts_plain
    from repro_torch.launch.train import param_shapes

    gen = torch.Generator(device=DEVICE).manual_seed(35)
    attn = _attention_case(gen, "llama-110m train", LLAMA_BATCH, cfg.n_heads, cfg.n_kv_heads,
                           LLAMA_SEQ, cfg.d_head, dtype="float32")
    ce = _cross_entropy_case(gen, "llama-110m", cfg.vocab_size, cfg.vocab_size,
                             rows=LLAMA_BATCH * LLAMA_SEQ)
    leaves = [torch.randn((numel,), generator=gen, device=DEVICE) * 1e-3
              for numel, _ in param_shapes(cfg)]
    total = sum(p.numel() for p in leaves)
    chains = ((("sqrt",),), (("sqrt",), ("clip_coeff", 1.0, 1e-9)))
    pros = ("square",) * len(leaves)

    def k4():
        return mma_sum_parts(leaves, prologue="square", total_chains=chains)

    out, plain = k4(), mma_sum_parts_plain(leaves, pros, chains, False)
    torch.cuda.synchronize()
    n_leaves = len(leaves)
    mass = float(plain[:n_leaves].sum())
    err = float((out - plain).abs().max())
    print(f"K4 mma_sum_parts, llama-110m's clip statistic: {n_leaves} f32 leaves, {total} "
          f"elements: max_abs_err {err:.3g} vs plain at mass {mass:.4g} (tol 1e-6 x mass)")
    check(err <= 1e-6 * mass, "K4 over llama-110m's leaves disagrees with its plain version")
    lib = getattr(torch.nn.utils, "get_total_norm", None)
    b4, by4 = bound_ms(total * 4 + out.numel() * 4, core_flops=2 * total)
    parts = {
        "max_abs_err": err, "leaves": n_leaves, "elements": total,
        "ms": device_ms(k4, "parts_kernel", iters=5, warmup=1),
        "call_ms": time_ms(k4, iters=5, warmup=1),
        "plain_ms": time_ms(lambda: mma_sum_parts_plain(leaves, pros, chains, False), iters=1,
                            warmup=0),
        "bound_ms": b4, "bound_by": by4,
        "library_ms": time_ms(lambda: lib(leaves), iters=5, warmup=1) if lib is not None else None,
    }
    del leaves
    torch.cuda.empty_cache()
    results["flash_attention"]["llama_110m"] = attn
    results["cross_entropy"]["llama_110m"] = ce
    results["mma_sum_parts"]["llama_110m"] = parts
    _print_cases([("llama-110m K6 8 x 12 x 512 x 64 f32", attn),
                  ("llama-110m K7 4096 x 32000 f32", ce), ("llama-110m K4 clip statistic", parts)])


def run_examples_phase() -> dict:
    """The reference's examples through the port's entry points, each
    under the launch meter: ``examples.quickstart.main([])`` (the sum of
    2^20 numbers on K1 against ``mma_sum`` on the same bf16-rounded
    operands within 1e-6 of their mass, then tiny olmo-1b's 10 steps with
    a falling loss), ``examples.serve_batched.main([])`` (6 and 4 outputs
    of 8 tokens, the same on a rerun) and ``examples.train_100m.main([])``
    at its defaults: full-width llama-110m, 300 steps of 8 x 512, its loss
    falling, every kernel's launches held to ``train_launches_per_step``
    (K5b, K6, K7, K1 and K4 each launched). Prints the parameter count,
    the loss every 30 steps, the step wall's p50, the steps a second and
    the peak device memory. Returns the launches of each and the run's
    figures."""
    import numpy as np
    import torch

    from repro_torch.examples import quickstart, serve_batched, train_100m
    from repro_torch.launch.train import param_shapes

    t0 = time.perf_counter()
    qs, qs_launches = counted_run(lambda: quickstart.main([]))
    x = torch.from_numpy(np.random.RandomState(0).randn(quickstart.N).astype(np.float32))
    want = float(x.to(torch.bfloat16).double().sum())  # the bf16 multipliers' exact sum
    mass = float(x.abs().sum())
    print(f"quickstart: {time.perf_counter() - t0:.2f} s; K1 {qs['reduce']:.6f}, mma_sum "
          f"{qs['mma_sum']:.6f} against the f64 sum of the bf16-rounded operands {want:.6f} "
          f"(tol 1e-6 x the mass {mass:.6g}; mma_sum's group sums re-enter at bf16: 2^-8 "
          f"of the sum more); losses {[round(v, 4) for v in qs['losses']]}; launches "
          f"{qs_launches}")
    check(abs(qs["reduce"] - want) <= 1e-6 * mass, "quickstart: K1 is off the exact sum")
    check(abs(qs["mma_sum"] - want) <= 1e-6 * mass + 2.0**-8 * abs(want),
          "quickstart: mma_sum is off the exact sum")
    check(all(np.isfinite(qs["losses"])) and qs["losses"][-1] < qs["losses"][0],
          "quickstart: the tiny model's loss did not fall")
    check(qs_launches["mma_sum_fused"] >= 1, "quickstart: the reduction did not launch K1")
    t0 = time.perf_counter()
    served, sb_launches = counted_run(lambda: serve_batched.main([]))
    again = serve_batched.main([])
    print(f"serve_batched: {time.perf_counter() - t0:.2f} s (twice); outputs "
          f"{[[len(o) for o in run] for run in served]}; launches {sb_launches}")
    check([[len(o) for o in run] for run in served] == [[8] * 6, [8] * 4],
          "serve_batched: not 6 and 4 outputs of 8 tokens")
    check(served == again, "serve_batched: a rerun served other tokens")
    check(sb_launches["layernorm_np"] > 0 and sb_launches["rmsnorm"] > 0,
          "serve_batched: the norms did not launch their kernels")

    cfg = train_100m.CFG_100M
    per_step = train_launches_per_step(cfg, LLAMA_SEQ)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    t0 = time.perf_counter()
    losses, launches = counted_run(lambda: train_100m.main([], walls=walls))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(numel for numel, _ in param_shapes(cfg))
    p50 = float(np.median(walls))
    print(f"train_100m: {cfg.name}, {n_params} parameters ({n_params / 1e6:.1f}M), "
          f"{LLAMA_STEPS} steps of {LLAMA_BATCH} x {LLAMA_SEQ} in {wall:.2f} s (initialisation "
          f"included); loss {losses[0]:.4f} -> {losses[-1]:.4f}; every {LLAMA_LOG_EVERY} steps "
          f"{[round(v, 4) for v in losses[LLAMA_LOG_EVERY - 1::LLAMA_LOG_EVERY]]}; "
          f"step wall p50 {p50 * 1e3:.3f} ms ({1 / p50:.3f} steps/s), min "
          f"{min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}; peak device memory "
          f"{peak:.3f} GB; launches a step "
          f"{ {k: v / LLAMA_STEPS for k, v in launches.items() if v} }")
    check(len(losses) == LLAMA_STEPS and all(np.isfinite(losses)) and losses[-1] < losses[0],
          "train_100m: the loss is not finite or did not fall")
    for k, n in per_step.items():
        check(launches[k] == n * LLAMA_STEPS,
              f"train_100m: {k}: {launches[k]} launches, expected {n * LLAMA_STEPS}")
    for k in ("rmsnorm", "flash_attention", "cross_entropy", "mma_sum_fused", "mma_sum_parts"):
        check(launches[k] > 0, f"train_100m: {k} was not launched")
    torch.cuda.empty_cache()
    return {"quickstart": qs_launches, "serve_batched": sb_launches, "train_100m": launches,
            "losses": losses, "p50_ms": p50 * 1e3, "steps_per_s": 1 / p50, "peak_gb": peak,
            "wall_s": wall, "params": n_params}


# ------------------------------- the data mesh -------------------------------

# The data-mesh phase's training run: olmo-1b at full width cut to
# MESH_LAYERS of its 16 layers (the whole script's time: at full depth the
# run's 4.7 GB a step through gloo took ~150 s; 4 layers until the sharded
# phase took the MLA, RG-LRU and cross-attention archs), two ranks sharing the card
# (gloo), the global batch 4 x 512 split 2 + 2,
# rank 1's gradients poisoned with NaN on step 2 and --max-bad-steps 1, so
# step 2 is skipped on both ranks and rolls back to the step-0 anchor; then
# steps 1-2 again, clean (the drill fires once). Four step calls a rank.
MESH_WORLD, MESH_STEPS, MESH_NAN_STEPS, MESH_HOST, MESH_LAYERS = 2, 2, (2,), 1, 2
# Its step-1 loss, grad norm and clip against the single-rank guarded step's
# on the same global batch at the same depth (``guarded_step1``). The loss is
# the mean over the rows each rank took, combined, and reads bitwise equal
# on the card; its limit leaves room for cuBLAS picking other kernels for
# the ranks' 1024 rows than for the single rank's 2048, and sits under the
# gap between a half batch's loss and the whole batch's
# (``tools/mesh_grad_probe.py``), so a rank that takes the wrong rows
# fails it. The grad norm and the clip come after the combine, and the two
# routes round differently: olmo-1b's tied bf16 embedding sums its
# gradient over 2044 tokens on one rank and over 1022 on each mesh rank,
# and the probe reads that leaf's norm 3.9% under the f32 reference's on
# one rank and 2.1% under on the mesh (every other leaf within 2.1e-4), so
# the global norm and the clip read 2.5e-3 apart at full depth, and 4.6e-3
# at 4 layers (the embedding's share of the norm is larger there; at 2 it
# is larger again, read in PERF.md section 6). The limit is twice the
# 4-layer reading; a combine that drops a rank's gradients or skips the
# division moves them by a factor, and one that differs between ranks
# fails the bitwise agreement of every step's metrics.
MESH_LOSS_TOL, MESH_GRAD_REL = 1e-3, 1e-2
# The engine's limit against the world-1 value: ``tests/harness.py``'s
# ``budget_for(x, "norm2", f32 multipliers)``: 2e-4 of the sum of squares
# over twice the norm, plus 1e-6.
MESH_REL = 2e-4


def _mesh_rank(rank: int, world: int, tmp: str, job: str, kw: dict) -> None:
    """One rank of a data-mesh run, started by ``torch.multiprocessing.spawn``
    (this script re-imported in a fresh process): the launcher's
    environment, then ``job``; what it returns goes to ``tmp`` as JSON and
    what it prints to ``tmp/rank<r>.log``. A rank that raises fails the
    spawn, and the script with it. With ``kw["one_card"]`` the rank sees the
    first visible card alone, so ranks share it whatever the host holds."""
    sys.path.insert(0, SRC)
    if kw.get("one_card"):  # before CUDA starts in this process
        os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES",
                                                            "0").split(",")[0]
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(kw["port"]))
    with open(os.path.join(tmp, f"rank{rank}.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        out = {"engine": _mesh_engine_rank, "train": _mesh_train_rank,
               "sharded": _sharded_rank, "serving": _serving_rank,
               "uneven": _uneven_rank}[job](rank, world, kw)
        if "peak_gb" not in out:
            out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if torch.cuda.is_initialized() else 0.0)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def spawn_ranks(job: str, world: int, **kw) -> list:
    """``world`` ranks of ``job`` (``_mesh_rank``), joined: each rank's
    result and its log, in rank order."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        kw = dict(kw, port=free_port(), tmp=tmp)
        t0 = time.perf_counter()
        mp.spawn(_mesh_rank, args=(world, tmp, job, kw), nprocs=world)
        print(f"data mesh, {job}: {world} ranks ran in {time.perf_counter() - t0:.1f} s")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res = json.load(f)
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                res["log"] = f.read()
            results.append(res)
    return results


def _nudge(t):
    import torch

    return torch.nextafter(t, torch.full_like(t, float("inf")))


def _mesh_engine_rank(rank: int, world: int, kw: dict) -> dict:
    """(a) and (c): ``reduce_tree(census=True, mesh_axes="data")`` over
    olmo-1b's 113 gradient-shaped f32 leaves at full width, split by rows
    across the ranks (each leaf drawn whole from its own seed, so every
    world reduces the same values): K4 launches and received bytes metered,
    repeated, timed, then with a NaN planted in the last rank's shard of
    leaf 7; with two or more ranks also the planted one-ulp faults."""
    import torch

    from repro_torch import reduce as R
    from repro_torch.configs import get_arch
    from repro_torch.core import collectives as C
    from repro_torch.core.cost_model import interconnect_bytes
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.reduce import inspect
    from repro_torch.runtime import (AgreementChecker, DivergenceError, FileTransport,
                                     exchange, step_fingerprint)

    _, _, dev, transport = mesh_lib.init_process_group(kw.get("device"), backend=kw["backend"])
    on_card = dev.type == "cuda"
    try:
        mesh = mesh_lib.make_data_mesh()
        shards = []
        for i, shape in enumerate(olmo_leaf_shapes(get_arch("olmo-1b", tiny=kw["tiny"]))):
            gen = torch.Generator(device=dev).manual_seed(1000 + i)
            full = torch.randn(shape, generator=gen, device=dev) * 1e-3
            shards.append(full.tensor_split(world, dim=0)[rank].clone())
            del full
        s = len(shards)

        def call(leaves=shards):
            out = R.reduce_tree(leaves, "norm2", backend="cuda_fused", census=True,
                                mesh_axes="data")
            if on_card:
                torch.cuda.synchronize()
            return out

        res = {"transport": transport, "leaves": s, "rank_elements": sum(x.numel() for x in shards)}
        with C.bound_mesh(mesh):
            call()  # warm-up
            (norm, counts), launches = R.count_kernel_launches(call, include_plain=not on_card)
            got = {}
            recv = inspect.collective_recv_bytes(lambda: got.setdefault("out", call()))
            norm2, _ = got["out"]
            t0 = time.perf_counter()
            for _ in range(10):
                call()
            res["call_ms"] = (time.perf_counter() - t0) / 10 * 1e3
            row = torch.zeros(2 * s + 2, device=dev)
            t0 = time.perf_counter()
            for _ in range(10):
                C.fixed_order_combine(row, ("data",))
            if on_card:
                torch.cuda.synchronize()
            res["combine_ms"] = (time.perf_counter() - t0) / 10 * 1e3
            bad = list(shards)
            if rank == world - 1:
                bad[7] = shards[7].clone()
                bad[7].view(-1)[-1] = float("nan")
            nan_norm, nan_counts = call(bad)
            res.update(norm=float(norm).hex(), repeat=float(norm2).hex(),
                       counts=counts.tolist(), launches=launches, recv_bytes=recv,
                       model_bytes=interconnect_bytes(2 * s + 2, world).recv_per_device,
                       nan_norm=float(nan_norm).hex(), nan_counts=nan_counts.tolist())
            if world > 1:
                # (c): rank 1's copy of the (replicated) norm one ulp off; rank
                # 1's fold one ulp off; rank 1's fingerprint one ulp off
                held = _nudge(norm) if rank == 1 else norm.clone()
                res["fault_bits_agree"] = bool(C.replica_bits_agree(held, ("data",)))
                real = C.fixed_order_combine
                if rank == 1:
                    C.fixed_order_combine = lambda x, axes: _nudge(real(x, axes))
                try:
                    _, agree = C.census_agreement(counts, ("data",))
                finally:
                    C.fixed_order_combine = real
                res["fault_census_agree"] = bool(agree)
                _, clean_agree = C.census_agreement(counts, ("data",))
                res["clean_census_agree"] = bool(clean_agree)
                transport_dir = FileTransport(os.path.join(kw["tmp"], "fingerprints"))
                skipped = (counts[-1] > 0).to(torch.float32)
                res["checker_clean"] = exchange(
                    AgreementChecker(world), transport_dir, 1, rank,
                    step_fingerprint(1, counts, skipped, norm))
                try:
                    exchange(AgreementChecker(world), transport_dir, 2, rank,
                             step_fingerprint(2, counts, skipped, held))
                    res["checker_fault"] = None
                except DivergenceError as e:
                    res["checker_fault"] = [e.step, e.host]
    except BaseException:
        mesh_lib.shutdown(barrier=False)
        raise
    mesh_lib.shutdown()
    return res


def _mesh_train_rank(rank: int, world: int, kw: dict) -> dict:
    """(b) and (d): the training CLI's ``main`` with ``--guard --mesh`` on
    this rank, its step wrapped to record, per call: host wall time, the
    device's busy time (the profiler), the combine's seconds and bytes
    (the step's ``combine_bytes``, from ``interconnect_bytes``, beside the
    bytes the meter saw its all-gathers bring in:
    ``reduce.inspect.collective_recv_bytes`` around the step, which costs
    host time only), the transport and device of the rank's mesh, the
    device's peak memory in the step, whether a poisoned step left the
    parameters bitwise, and an agreement round (``step_fingerprint`` over
    ``FileTransport``, which raises on a divergence). Every kernel launch
    of the run counted."""
    import torch

    from repro_torch import reduce as R
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_cli
    from repro_torch.reduce import inspect
    from repro_torch.runtime import AgreementChecker, ChaosMonkey, FileTransport, exchange
    from repro_torch.runtime import step_fingerprint

    calls = []
    real = train_cli.make_mesh_guarded_train_step
    on_card = kw["device"] != "cpu"

    def recording(cfg, tcfg, mesh, *args, **kwargs):
        step = real(cfg, tcfg, mesh, *args, **kwargs)
        checker = AgreementChecker(world)
        fps = FileTransport(os.path.join(kw["tmp"], "fingerprints"))

        def run(params, opt, guard, batch):
            n = len(calls) + 1
            scale = batch.get("chaos_scale")
            poisoned = scale is not None and not bool(torch.isfinite(scale).all())
            before = ([p.detach().clone() for p in R.tree_leaves(params)] if poisoned
                      else None)
            out = []
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            got = {}

            def metered():
                got["recv"] = inspect.collective_recv_bytes(
                    lambda: out.append(step(params, opt, guard, batch)))

            t0 = time.perf_counter()
            if on_card and kw.get("profile"):
                events = device_events(metered)
                busy = sum(us for _, us in events.values()) / 1e3 if events else None
            else:
                metered()
                busy = None
            if on_card:
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            step_peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
            params, opt, guard, m = out[0]
            fp = step_fingerprint(n, m["nonfinite"], m["skipped"],
                                  torch.stack([m["loss"], m["grad_norm"], m["clip"]]))
            agreed = exchange(checker, fps, n, rank, fp)
            unchanged = None if before is None else _bitwise_equal(before,
                                                                   R.tree_leaves(params))
            calls.append(dict(call=n, wall_ms=wall, busy_ms=busy, loss=float(m["loss"]),
                              grad_norm=float(m["grad_norm"]), clip=float(m["clip"]),
                              skipped=float(m["skipped"]), nonfinite=float(m["nonfinite"]),
                              combine_s=m["combine_s"], combine_bytes=m["combine_bytes"],
                              recv_bytes=got["recv"], transport=mesh.backend,
                              device=str(mesh.device),
                              unchanged=unchanged, agreed=agreed, step_peak_gb=step_peak))
            return out[0]

        return run

    train_cli.make_mesh_guarded_train_step = recording
    if kw.get("params"):  # the same weights on every device (card against CPU)
        saved = torch.load(kw["params"])
        train_cli.init_params = lambda cfg, gen, device: _cpu_copy(saved, device)
    cfg = get_arch("olmo-1b", tiny=kw["tiny"])
    if kw.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=kw["layers"])
    chaos = ChaosMonkey(nan_steps=kw["nan_steps"], host=kw["host"]) if kw["nan_steps"] else None
    run = lambda: train_cli.main(kw["argv"], cfg=cfg, chaos=chaos)  # noqa: E731
    if on_card:
        losses, launches = R.count_kernel_launches(run)
    else:
        losses, launches = run(), {}
    return {"calls": calls, "losses": losses, "launches": launches,
            "peak_gb": max(c["step_peak_gb"] for c in calls)}


def _mesh_lines(log: str) -> list:
    """A rank's per-step metric lines, its rank and timings taken out."""
    return [line.split(" rank ")[0] + ":" + line.split(":", 1)[1].split("; combine")[0]
            for line in log.splitlines() if line.startswith("mesh step ")]


def _guard_lines(log: str) -> list:
    return [line for line in log.splitlines() if line.startswith("guard:")]


def check_mesh_engine() -> dict:
    """(a) and (c): the engine's mesh path under NCCL at world
    min(device_count, 4) (1 on a one-card machine: the world-1 value) and
    under gloo at world 2 with both ranks on card 0; NCCL refused for two
    ranks on one card."""
    import torch

    from repro_torch.launch.mesh import choose_backend

    try:
        choose_backend(torch.device("cuda", 0), 2 * torch.cuda.device_count(), "nccl")
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"NCCL asked for two ranks on one card: {refused}")
    check(refused is not None and "Duplicate GPU detected" in refused,
          "NCCL was not refused for two ranks on one card")
    out = {}
    for backend, world in (("nccl", min(torch.cuda.device_count(), 4)), ("gloo", 2)):
        ranks = spawn_ranks("engine", world, backend=backend, tiny=False,
                            one_card=backend == "gloo")
        for r, res in enumerate(ranks):
            print(f"engine, {backend} world {world} rank {r}: {res['log'].strip()}; norm "
                  f"{float.fromhex(res['norm'])!r} over {res['rank_elements']} elements of "
                  f"{res['leaves']} leaves; K4 launches {res['launches']['mma_sum_parts']}, "
                  f"all kernels {sum(res['launches'].values())}; "
                  f"received {res['recv_bytes']} B (model {res['model_bytes']}); call "
                  f"{res['call_ms']:.3f} ms, combine of the {2 * res['leaves'] + 2}-slot row "
                  f"{res['combine_ms']:.3f} ms; NaN-planted counts total "
                  f"{res['nan_counts'][-1]:.0f}; peak {res['peak_gb']:.2f} GB")
        check(all(r["transport"] == backend for r in ranks), f"engine: transport not {backend}")
        check(len({(r["norm"], r["repeat"], tuple(r["counts"])) for r in ranks}) == 1,
              f"engine, {backend}: the ranks hold different bits")
        check(all(r["norm"] == r["repeat"] for r in ranks),
              f"engine, {backend}: two runs gave different bits")
        check(all(r["launches"]["mma_sum_parts"] == 1
                  and sum(r["launches"].values()) == 1 for r in ranks),
              f"engine, {backend}: not one K4 launch a rank")
        check(all(r["recv_bytes"] == r["model_bytes"] for r in ranks),
              f"engine, {backend}: received bytes differ from interconnect_bytes")
        s = ranks[0]["leaves"]
        check(all(c == 0 for c in ranks[0]["counts"]), f"engine, {backend}: census of clean "
              "leaves not 0")
        want = [0.0] * (s + 1)
        want[7], want[s] = 1.0, 1.0
        check(len({(r["nan_norm"], tuple(r["nan_counts"])) for r in ranks}) == 1
              and ranks[0]["nan_counts"] == want and math.isnan(float.fromhex(
                  ranks[0]["nan_norm"])), f"engine, {backend}: the planted NaN's census is "
              "not exact on every rank")
        out[backend] = ranks
    base = float.fromhex(out["nccl"][0]["norm"])
    got = float.fromhex(out["gloo"][0]["norm"])
    budget = MESH_REL * base * base / (2.0 * base) + 1e-6
    print(f"engine: gloo world 2 norm {got!r} against the world-1 value {base!r}: |d| "
          f"{abs(got - base):.3g} (budget_for {budget:.3g})")
    check(abs(got - base) <= budget, "engine: the mesh norm is off the world-1 value")
    for r in out["gloo"]:
        print(f"planted faults, rank {out['gloo'].index(r)}: replica_bits_agree "
              f"{r['fault_bits_agree']}, census_agreement {r['fault_census_agree']} (clean "
              f"{r['clean_census_agree']}), checker {r['checker_fault']} (clean "
              f"{r['checker_clean']})")
        check(r["clean_census_agree"] and r["checker_clean"],
              "engine: the clean agreement checks failed")
        check(not r["fault_bits_agree"] and not r["fault_census_agree"]
              and r["checker_fault"] == [2, 1],
              "engine: a planted one-ulp fault was not reported on every rank")
    return {"nccl_world": len(out["nccl"]), "call_ms": [r["call_ms"] for r in out["gloo"]],
            "combine_ms": [r["combine_ms"] for r in out["gloo"]]}


def guarded_step1(cfg) -> dict:
    """The training CLI's single-rank guarded step 1 (``--guard
    --reduce-backend cuda_fused``, batch 4 x 512) at ``cfg``: its loss, grad
    norm and clip at full precision, and its host wall."""
    import torch

    from repro_torch.launch import train as train_cli

    step1 = {}
    real_make = train_cli.make_guarded_train_step

    def recording(*args, **kwargs):  # the CLI's step, its first call's metrics kept
        step = real_make(*args, **kwargs)

        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            if not step1:
                step1.update(grad_norm=float(out[3]["grad_norm"]), clip=float(out[3]["clip"]),
                             wall_ms=(time.perf_counter() - t0) * 1e3)
            return out

        return run

    train_cli.make_guarded_train_step = recording
    try:
        losses = train_cli.main(["--arch", "olmo-1b", "--guard", "--reduce-backend",
                                 "cuda_fused", "--steps", "1", "--batch", str(TRAIN_BATCH),
                                 "--seq", str(TRAIN_SEQ)], cfg=cfg)
    finally:
        train_cli.make_guarded_train_step = real_make
    torch.cuda.empty_cache()
    return dict(step1, loss=losses[0])


def run_data_mesh_phase() -> dict:
    """The data mesh on the card: (a) and (c) ``check_mesh_engine``; (b)
    ``python -m repro_torch.launch.train --arch olmo-1b --guard --mesh
    --chaos-host 1`` at full width cut to ``MESH_LAYERS``, two ranks
    sharing the first card on gloo (``MESH_*``; pinned to it on a host of
    several cards, where the ranks would otherwise get a card each and
    NCCL), against the single-rank guarded step at that depth on the same
    global batch (``guarded_step1``: its step-1 loss, grad norm, clip and
    wall); (d) tiny olmo-1b at world 2 on the card against two CPU ranks.
    Returns the launches of the training run's rank 0 (its main path)."""
    import tempfile

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.launch import train as train_cli

    t_phase = time.time()
    engine = check_mesh_engine()
    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=MESH_LAYERS)
    single = guarded_step1(cfg)
    per_rank = (train_cli.train_step_peak_bytes(cfg, TrainConfig(), guard=True)
                + train_cli.combine_peak_bytes(cfg, MESH_WORLD))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ckpt:
        argv = ["--arch", "olmo-1b", "--guard", "--mesh", "--chaos-host", str(MESH_HOST),
                "--reduce-backend", "cuda_fused", "--steps", str(MESH_STEPS), "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1",
                "--max-bad-steps", "1", "--ckpt-dir", ckpt, "--ckpt-every", "100"]
        ranks = spawn_ranks("train", MESH_WORLD, argv=argv, tiny=False, device="cuda",
                            nan_steps=list(MESH_NAN_STEPS), host=MESH_HOST, profile=True,
                            one_card=True, layers=MESH_LAYERS)
    print("data mesh, training rank 0's log:\n" + ranks[0]["log"])
    for r, res in enumerate(ranks):
        for c in res["calls"]:
            busy = "not measured" if c["busy_ms"] is None else f"{c['busy_ms']:.3f} ms"
            print(f"data mesh step call {c['call']} rank {r}: wall {c['wall_ms']:.3f} ms, device "
                  f"busy {busy}, combine {c['combine_s']:.4f} s {c['combine_bytes']} B "
                  f"modelled, {c['recv_bytes']} B metered, over {c['transport']} on "
                  f"{c['device']}, peak {c['step_peak_gb']:.2f} GB, loss {c['loss']!r}, "
                  f"grad norm {c['grad_norm']!r}, clip {c['clip']!r}, skipped "
                  f"{c['skipped']:.0f}, agreed {c['agreed']}")
        print(f"data mesh rank {r}: peak device memory {res['peak_gb']:.2f} GB in a step (the "
              f"fit check's model of a rank {per_rank / 1e9:.2f} GB + "
              f"{train_cli.ACTIVATION_RESERVE_BYTES / 1e9:.0f} GB reserve); launches "
              f"{res['launches']}")
    lines = [_mesh_lines(r["log"]) for r in ranks]
    check(len(lines[0]) == 2 + MESH_STEPS and all(ln == lines[0] for ln in lines),
          "data mesh: the ranks printed different per-step metrics")
    check(all(_guard_lines(r["log"]) == _guard_lines(ranks[0]["log"]) for r in ranks),
          "data mesh: the guard's skips and rollback differ between ranks")
    check(any(ln.startswith("guard: rolled back to step 0") for ln in _guard_lines(
        ranks[0]["log"])), "data mesh: no rollback")
    for r in ranks:
        calls = r["calls"]
        check([c["skipped"] for c in calls] == [0.0, 1.0, 0.0, 0.0],
              f"data mesh: skips {[c['skipped'] for c in calls]}, expected call 2 alone")
        check(calls[1]["nonfinite"] > 0 and calls[1]["unchanged"] is True,
              "data mesh: the poisoned step did not pass the parameters through bitwise")
        check(all(c["agreed"] for c in calls), "data mesh: an agreement round failed")
        check(all(c["transport"] == "gloo" and c["device"] == "cuda:0" for c in calls),
              "data mesh: the ranks did not share card 0 over gloo")
        check(all(c["recv_bytes"] == c["combine_bytes"] for c in calls),
              "data mesh: the metered combine bytes differ from interconnect_bytes")
        check(r["peak_gb"] * 1e9 <= per_rank + train_cli.ACTIVATION_RESERVE_BYTES,
              "data mesh: a rank's step peak is past the fit check's model and reserve")
        n = len(calls)
        for k, per in train_launches_per_step(cfg).items():
            check(r["launches"][k] == per * n,
                  f"data mesh: {k}: {r['launches'][k]} launches in {n} steps, expected {per * n}")
    first, one = ranks[0]["calls"][0], single
    dl = abs(first["loss"] - single["loss"])
    dg = {k: abs(first[k] - one[k]) / one[k] for k in ("grad_norm", "clip")}
    print(f"data mesh step 1 ({MESH_LAYERS} layers) against the single-rank guarded step's on "
          f"the same global batch: loss {first['loss']!r} vs {single['loss']!r} (|d| {dl:.3g}, "
          f"tol {MESH_LOSS_TOL}); grad norm {first['grad_norm']!r} vs {one['grad_norm']!r} "
          f"(rel. {dg['grad_norm']:.3g}, tol {MESH_GRAD_REL}); clip {first['clip']!r} vs "
          f"{one['clip']!r} (rel. {dg['clip']:.3g}, tol {MESH_GRAD_REL}); single-rank guarded "
          f"step wall {single['wall_ms']:.3f} ms")
    check(dl <= MESH_LOSS_TOL, "data mesh: the step-1 loss is off the single-rank guarded step's")
    check(all(d <= MESH_GRAD_REL for d in dg.values()),
          "data mesh: the step-1 grad norm or clip is off the single-rank guarded step's")
    # (d) tiny olmo-1b at world 2, card against CPU ranks, from the same weights
    import torch

    from repro_torch.models import init_params

    tiny = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        weights = os.path.join(tmp, "tiny_olmo.pt")
        torch.save(init_params(get_arch("olmo-1b", tiny=True), torch.Generator().manual_seed(0),
                               torch.device("cpu")), weights)
        for device in ("cuda", "cpu"):
            argv = ["--arch", "olmo-1b", "--tiny", "--guard", "--mesh", "--reduce-backend",
                    "cuda_fused", "--steps", "2", "--batch", "4", "--seq", "16", "--log-every",
                    "1"]
            if device == "cpu":
                argv += ["--device", "cpu"]
            tiny[device] = spawn_ranks("train", 2, argv=argv, tiny=True, device=device,
                                       nan_steps=[], host=1, profile=False, params=weights)
    for step in range(2):  # the limits of check_tiny_training_against_cpu
        g, c = (tiny[d][0]["calls"][step] for d in ("cuda", "cpu"))
        dl = abs(g["loss"] - c["loss"])
        dg = abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
        print(f"tiny olmo-1b data mesh step {step + 1}, card vs CPU ranks: loss {g['loss']!r} "
              f"vs {c['loss']!r} (|d| {dl:.3g}, tol 1e-3), grad norm rel. diff {dg:.3g} (tol "
              "1e-3)")
        check(dl <= 1e-3 and dg <= 1e-3, "tiny data mesh: card and CPU ranks differ")
    check(all(_mesh_lines(r["log"]) == _mesh_lines(tiny["cuda"][0]["log"])
              for r in tiny["cuda"]), "tiny data mesh: the card's ranks differ")
    print(f"data mesh phase: {time.time() - t_phase:.1f} s")
    return {"launches": ranks[0]["launches"], "engine": engine,
            "calls": [r["calls"] for r in ranks], "peak_gb": [r["peak_gb"] for r in ranks]}


# ---------------- the sharded step: FSDP, TP and EP over (data, model) ----------------

SHARDED_SHAPE, SHARDED_AXES = (2, 2), ("data", "model")
SHARDED_WORLD, SHARDED_STEPS, SHARDED_SEED = 4, 2, 0
# granite-moe-1b-a400m's depth in the sharded training run, cut from 24 (12
# until the MLA, RG-LRU and cross-attention archs joined the phase: the
# script's time limit, PERF.md section 4).
SHARDED_GRANITE_LAYERS = 6
# deepseek-7b's: the deepest cut the sharded fit check accepts (5 layers),
# capped at 3 for the script's time limit.
SHARDED_DEEPSEEK_LAYERS = 3
# The MLA, RG-LRU and cross-attention archs at full width under
# DEFAULT_RULES, each at the least depth that holds every block kind of
# its pattern, on the mesh whose four ranks the fit check lets share one
# card: minicpm3-4b (MLA) at 1 layer (2 until the uneven-heads phase
# joined the script: its time limit) and llama-3.2-vision-11b (four attn,
# one xattn) at 5 on (data 2, model 2); recurrentgemma-9b (rec, rec,
# local_attn) at 3 on (data 1, model 4). On (2, 2) its 256 000-row
# embedding and head, cut in two, hold 16.8 GB a rank in parameters,
# moments, accumulators and gradients alone, and the fit check refuses four
# such ranks on one card at any depth (99.5 GB with the reserve at 3
# layers); over 4 model ranks they hold half that (79.1 GB in all).
# mamba2-780m (DEFAULT_RULES: the SSM's tensor parallelism, 24 of 48 heads a
# rank, its tied 50 432-row table cut in two) and musicgen-medium
# (SMALL_MODEL_RULES, as the reference's rules choice gives it: FSDP and its
# four codebook streams vocab-parallel) at 2 layers on (2, 2).
SHARDED_MIXERS = {MINICPM: (1, (2, 2)), VISION: (5, (2, 2)), RG: (3, (1, 4)),
                  MAMBA: (2, (2, 2)), MUSICGEN: (2, (2, 2))}
SHARDED_ARCHS = ("deepseek-7b", GRANITE) + tuple(SHARDED_MIXERS)
# The archs whose sharded run (and its single rank) keeps the fused second
# moment (``TrainConfig(fused_second_moment=True)``: one scalar EMA a
# reference leaf, its group sizes the whole leaves' under the sharded step).
SHARDED_FUSED = (MUSICGEN,)
# The learning rate is past warmup from step 1 (3e-4), so that step 1's
# AdamW update moves the bf16 weights by whole ulps and step 2 sees it (at
# the default warmup's 3e-6 most bf16 weights would not move at all).
SHARDED_WARMUP = 1
# Both steps against the single-rank step on the same weights and batches,
# both bf16 on the kernels: the model ranks' partial sums of each
# row-parallel product (o, down) add in another order than the whole
# product's, a bf16 rounding apart in the hidden states. On an H100 step 1
# read 4.05e-5 (deepseek-7b) and 4.44e-5 (granite) relative in the loss,
# 1.48e-4 and 2.2e-3 in the grad norm (PERF.md section 6). Limits: loss
# 1e-3 relative; the grad norm and clip, sums of bf16 gradients, 5e-3.
SHARDED_LOSS_REL, SHARDED_GRAD_REL = 1e-3, 5e-3
# Step 1's update (after - before, f32) of every probed leaf of at most
# 2^25 elements (layer 0's: attention, norms, router, experts; and the
# first rec and xattn block's), the ranks' blocks against the same blocks
# of the single-rank update: ||sharded - single|| / ||single|| a leaf. A
# step-1 AdamW update is lr x the gradient's sign an element, so bf16
# gradients that round apart flip the sign of those near 0; on the CPU
# (tests/test_torch_sharded_step.py, tiny internlm2-1.8b at bf16) that read
# 0.146, where a half batch of other rows reads 1.2-1.3 and a flipped update
# 2. A leaf the single rank left alone must stay so.
SHARDED_UPDATE_REL, SHARDED_PROBE_MAX = 0.5, 1 << 25
# Step 1's gradient of the same probed leaves, read from AdamW's first
# moment over the step's clip coefficient (after step 1, m = (1 - b1) clip
# g), each rank's block against the same block of the single rank's:
# ||sharded - single|| / ||single|| a leaf and a rank. The two sum bf16
# partial products in other orders; predicted near 1e-2, limit 0.05. Held
# for the MLA, RG-LRU and cross-attention archs, whose planted faults it
# reads: global rank 1's f of the mixer's input (MLA: its two latents and
# its RoPE key) summed twice in the backward, which doubles the gradient of
# the whole leaves before it on that rank (the block's norm; MLA's q_down,
# kv_down and latent norms): a gap near 1, which must read at least
# SHARDED_FAULT_X times the limit.
SHARDED_LEAF_GRAD_REL, SHARDED_FAULT_X = 0.05, 10
# Granite's drop fractions: the ranks of a data group route alike (bitwise:
# the same rows, the same router); against the single-rank step's routing
# of the same rows a pair may flip where two experts' probabilities sit a
# bf16 rounding apart: 0.01 of the pairs a layer.
SHARDED_DROP_TOL = 0.01
SHARDED_RULES = {"deepseek-7b": "DEFAULT_RULES", GRANITE: "SMALL_MODEL_RULES",
                 MINICPM: "DEFAULT_RULES", VISION: "DEFAULT_RULES", RG: "DEFAULT_RULES",
                 MAMBA: "DEFAULT_RULES", MUSICGEN: "SMALL_MODEL_RULES"}
# The mixer each new arch's planted fault goes into, and the function that
# takes its ``tp``. musicgen-medium's blocks run whole under its rules: its
# fault goes into the codebook lookup instead (``plant_book_slip``).
MIXER_FAULTS = {MINICPM: ("repro_torch.models.mla", "mla_train"),
                RG: ("repro_torch.models.rglru", "rglru_train"),
                VISION: ("repro_torch.models.attention", "cross_attention_apply"),
                MAMBA: ("repro_torch.models.ssm", "ssm_train")}


def sharded_specs(cfg, rules: str, mesh):
    """The spec tree of ``cfg``'s parameters under ``rules`` (from the meta
    device)."""
    import torch

    from repro_torch.launch import sharding as SH
    from repro_torch.models.model import init_params, param_axes

    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    return SH.param_shardings(param_axes(cfg), mesh, getattr(SH, rules), meta)


def sharded_fits(arch: str, layers: int, shape=SHARDED_SHAPE) -> bool:
    """Whether ``arch`` cut to ``layers`` passes the sharded fit check for
    ``SHARDED_WORLD`` ranks of a ``shape`` mesh on the card, and the
    single-rank check for the reference step (``launch.train.
    check_fits_card``)."""
    import dataclasses

    import torch

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import abstract_mesh

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    dev = torch.device("cuda", 0)
    mesh = abstract_mesh(shape, SHARDED_AXES)
    try:
        train_cli.check_fits_card(cfg, TrainConfig(), dev, ranks_on_card=SHARDED_WORLD,
                                  world=SHARDED_WORLD,
                                  shard=(mesh, sharded_specs(cfg, SHARDED_RULES[arch], mesh)))
        train_cli.check_fits_card(cfg, TrainConfig(), dev)
    except ValueError:
        return False
    return True


def sharded_cut_depth(arch: str) -> int:
    """The deepest cut of ``arch`` that ``sharded_fits``."""
    from repro_torch.configs import get_arch

    for layers in range(get_arch(arch).n_layers, 0, -1):
        if sharded_fits(arch, layers):
            return layers
    raise SmokeFailure(f"{arch}: no depth fits the card sharded over {SHARDED_WORLD} ranks")


def sharded_launches_per_step(cfg, vocab_parallel: bool = True) -> dict:
    """Kernel launches of a rank in one sharded step (one microbatch):
    each layer's norms and attention forward and in the recompute, the
    final norm once (``train_launches_per_step``, on the rank's heads);
    per loss chunk K7's partial variant forward and in the recompute (with
    the vocabulary whole over "model", K7 over the whole vocabulary
    instead), and the token sum's K1 both times too (the sharded forward
    runs its recomputes whole: ``launch.steps``); the clip statistic once
    (``clip_statistic_kernels``)."""
    chunks = -(-TRAIN_SEQ // LOSS_CHUNK)
    ce = 2 * chunks
    return dict(train_launches_per_step(cfg), cross_entropy=0 if vocab_parallel else ce,
                cross_entropy_partial=ce if vocab_parallel else 0, mma_sum_fused=2 * chunks)


def sharded_tcfg(arch: str):
    """The phase's ``TrainConfig`` of ``arch``: past warmup from step 1,
    and the fused second moment for ``SHARDED_FUSED``."""
    from repro_torch.configs import TrainConfig

    return TrainConfig(warmup_steps=SHARDED_WARMUP, fused_second_moment=arch in SHARDED_FUSED)


def sharded_opt(params, cfg, tcfg):
    """AdamW's state for ``params`` (the fused second moment's scalars one
    a reference leaf)."""
    from repro_torch import optim
    from repro_torch.models.convert import reference_leaf_groups

    return optim.init_state(params, fused_second_moment=tcfg.fused_second_moment,
                            leaf_groups=reference_leaf_groups(params, cfg))


def _sharded_batches(cfg, device) -> list:
    """The phase's global batches: tokens ((B, S + 1, K) with K codebook
    streams), and a cross-attention arch's context
    (``frontends.synth_image_embeds``), from a generator seeded 1."""
    import torch

    from repro_torch.models.frontends import synth_image_embeds
    from repro_torch.models.model import param_dtype

    gen = torch.Generator(device=device).manual_seed(1)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    out = []
    for _ in range(SHARDED_STEPS):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1) + books,
                                         generator=gen, device=device)}
        if cfg.n_img_tokens:
            batch["image_embeds"] = synth_image_embeds(gen, TRAIN_BATCH, cfg.n_img_tokens,
                                                       cfg.d_model, param_dtype(cfg), device)
        out.append(batch)
    return out


def _sharded_params(cfg, device):
    """The phase's whole weights: seeded, every cross-attention gate open
    (``OPEN_GATE``: at its init value 0 the block adds nothing, and its q,
    k, v and o get no gradient), for the single rank and the ranks alike."""
    import torch

    from repro_torch.models import init_params

    params = init_params(cfg, torch.Generator(device=device).manual_seed(SHARDED_SEED), device)
    open_gates(params, OPEN_GATE)
    return params


def _probe_leaves(params, cfg) -> list:
    """Leaf indices (``reduce.tree_leaves`` order) of the leaves of at most
    ``SHARDED_PROBE_MAX`` elements in layer 0 and in the first rec and the
    first xattn block, and a codebook arch's table."""
    from repro_torch import reduce as R

    layers = {0} | {cfg.pattern_layers.index(k) for k in ("rec", "xattn")
                    if k in cfg.pattern_layers}
    probed = {id(t) for i in layers for t in R.tree_leaves(params["layers"][i])}
    if cfg.n_codebooks:
        probed.add(id(params["embed"]["table"]))
    return [j for j, t in enumerate(R.tree_leaves(params))
            if id(t) in probed and t.numel() <= SHARDED_PROBE_MAX]


def plant_doubled_f(arch: str, rank: int):
    """On global rank 1, the f (``models.parallel.TP.enter``) of ``arch``'s
    new mixer sums the gradient twice: its backward runs the all-reduce and
    returns twice its sum, so every leaf before it that "model" leaves
    whole gets twice its gradient on that rank. Returns the undo."""
    import importlib

    import torch

    from repro_torch.core import collectives as C

    class DoubledF(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, axes, mesh):
            ctx.axes, ctx.mesh = axes, mesh
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return 2 * C.fixed_order_combine(g, ctx.axes, ctx.mesh), None, None

    class Planted:
        def __init__(self, tp):
            self.tp, self.mesh, self.axis = tp, tp.mesh, tp.axis

        def enter(self, x):
            return DoubledF.apply(x, C._block_axes(self.tp.axis), self.tp.mesh)

        def exit(self, y):
            return self.tp.exit(y)

        def both(self, s):
            return self.tp.both(s)

    path, name = MIXER_FAULTS[arch]
    module = importlib.import_module(path)
    real = getattr(module, name)

    def wrong(*args, tp=None, **kwargs):
        return real(*args, tp=Planted(tp) if tp is not None and rank == 1 else tp, **kwargs)

    setattr(module, name, wrong)
    return lambda: setattr(module, name, real)


def plant_book_slip(rank: int):
    """On global rank 1, the codebook lookup reads each token's row one row
    down its block (its offset ``Plan.book0`` one too large; the last row
    of the block misses): rank 1's streams look up their neighbours' rows,
    so the table's gradient lands one row off on that rank's block. The
    offset fault of the CPU case (``Plan.vocab0`` for ``book0``) hides at
    the full 2048 rows, where the two offsets agree. Returns the undo."""
    from repro_torch.models import parallel

    real = parallel.Plan.__init__

    def wrong(self, *args, **kwargs):
        real(self, *args, **kwargs)
        if rank == 1:
            self.book0 += 1

    parallel.Plan.__init__ = wrong
    return lambda: setattr(parallel.Plan, "__init__", real)


def plant_o_rows(rank: int):
    """On global rank 1, MLA's o cut one head below the rank's own block of
    rows (heads the model ranks do not divide, o gathered or held whole:
    ``models.parallel.Plan._mla_leaf``), so its heads' outputs meet
    another head's rows. Returns the undo."""
    from repro_torch.models import parallel

    real = parallel.Plan._mla_leaf

    def wrong(self, w, dim, mode, heads, width):
        if rank == 1 and dim == 0:
            heads = (heads[0] - 1, heads[1] - 1)
        return real(self, w, dim, mode, heads, width)

    parallel.Plan._mla_leaf = wrong
    return lambda: setattr(parallel.Plan, "_mla_leaf", real)


def plant_fault(arch: str, rank: int, fault=True):
    """``arch``'s planted fault on global rank 1 (``plant_doubled_f``, or
    ``plant_book_slip`` for the codebook arch; ``fault="o_rows"``:
    ``plant_o_rows``). Returns the undo."""
    if fault == "o_rows":
        return plant_o_rows(rank)
    return plant_doubled_f(arch, rank) if arch in MIXER_FAULTS else plant_book_slip(rank)


def fault_name(arch: str, fault=True) -> str:
    if fault == "o_rows":
        return "rank 1's o cut one head off its block of rows"
    if arch in MIXER_FAULTS:
        return f"rank 1's f in its {MIXER_FAULTS[arch][1]} summed twice"
    return "rank 1's codebook lookup one row off"


def _grad_gaps(opt, clip: float, single: dict, spec_leaves, mesh) -> list:
    """[leaf, ||mine - single|| / ||single||] of step 1's gradient a probed
    leaf, from AdamW's first moment over the clip coefficient
    (``SHARDED_LEAF_GRAD_REL``): the rank's block against the same block of
    the single rank's."""
    from repro_torch.launch import sharding as SH

    out = []
    for j, probe in single.items():
        mine = opt.m[j].detach().cpu() / clip
        ref = SH.block_of(probe["grad"], spec_leaves[j], mesh)
        den = float(ref.square().sum())
        num = float((mine - ref).square().sum())
        out.append([j, math.sqrt(num / den) if den > 0 else (0.0 if num == 0 else math.inf)])
    return out


def _sharded_job(rank: int, world: int, job: dict) -> dict:
    """One arch of the sharded phase on this rank: ``job["arch"]`` cut to
    ``job["layers"]`` under its rules on a ``job["shape"]`` mesh of ranks
    sharing the first card (gloo); the weights drawn whole from the
    phase's seed on the card and cut to the rank's blocks;
    ``SHARDED_STEPS`` steps of the global batch, step 1 under the launch
    meter, the collective meter (c10d bytes) and the traffic notes; the
    replicas' bits; the routing's drop fractions; step 1's update and
    gradient of the probed leaves against the single rank's (saved by
    ``_sharded_single`` to ``job["probe"]``). With ``job["fault"]``, step 1
    again from the same start with ``plant_fault``: its gradient gaps and
    the replicas' bits."""
    import dataclasses
    import gc

    import torch

    from repro_torch import reduce as R
    from repro_torch.configs import get_arch
    from repro_torch.core import collectives as C
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.dryrun import summarize
    from repro_torch.launch.steps import make_train_step
    from repro_torch.reduce import inspect

    t_job = time.perf_counter()
    mesh = mesh_lib.make_mesh(job["shape"], SHARDED_AXES)
    cfg = dataclasses.replace(get_arch(job["arch"]), n_layers=job["layers"])
    tcfg = sharded_tcfg(job["arch"])
    specs = sharded_specs(cfg, job["rules"], mesh)
    spec_leaves = SH.tree_leaves(specs)
    dev = mesh.device
    data = mesh.size // mesh.axis_size("model")
    train_cli.check_fits_card(cfg, tcfg, dev, ranks_on_card=world, world=world,
                              shard=(mesh, specs))

    def start():
        full = _sharded_params(cfg, dev)
        params = SH.shard_tree(full, specs, mesh)
        del full
        torch.cuda.empty_cache()
        for p in R.tree_leaves(params):
            p.requires_grad_(True)
        return params, sharded_opt(params, cfg, tcfg), make_train_step(cfg, tcfg, mesh=mesh,
                                                                       param_shardings=specs)

    def replicas(params):
        agree = True
        for p, s in zip(R.tree_leaves(params), spec_leaves):
            whole = tuple(ax for ax in mesh.axis_names if ax not in SH.spec_axes(s))
            if whole:
                agree &= bool(C.replica_bits_agree(p.detach(), whole, mesh))
        return agree

    single = torch.load(job["probe"])  # {leaf: the single rank's whole update and gradient}
    batches = _sharded_batches(cfg, dev)
    params, opt, step = start()
    leaves = R.tree_leaves(params)
    before = {j: leaves[j].detach().to("cpu", copy=True) for j in single}
    metrics, walls, out, update, grads = [], [], {}, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        if i == 0:
            def metered():
                with C.traffic() as notes:
                    eqns = inspect.collective_eqns(
                        lambda: out.update(res=step(params, opt, batch)))
                out.update(notes=notes, eqns=eqns)

            (_, routes), launches = counted_run(lambda: record_routing(metered))
        else:
            out["res"] = step(params, opt, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        params, opt, m = out.pop("res")
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:  # the rank's blocks of step 1's update against the single rank's
            leaves = R.tree_leaves(params)
            for j, probe in single.items():
                mine = leaves[j].detach().cpu().float() - before[j].float()
                ref = SH.block_of(probe["update"], spec_leaves[j], mesh)
                update.append([j, float((mine - ref).square().sum()),
                               float(ref.square().sum()), float((mine + ref).square().sum()),
                               float(mine.square().sum())])
            grads = _grad_gaps(opt, metrics[0]["clip"], single, spec_leaves, mesh)
            del before
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = {"metrics": metrics, "wall_ms": walls, "launches": launches, "update": update,
           "grad_gaps": grads, "replicas_agree": replicas(params),
           "drops": drop_fractions(routes[:job["layers"]]), "transport": mesh.backend,
           "device": str(dev), "peak_gb": peak_gb,
           "model_gb": (train_cli.sharded_step_peak_bytes(cfg, tcfg, mesh, specs)
                        + train_cli.ACTIVATION_RESERVE_BYTES // data) / 1e9}
    records = {}
    for kind, ax, b in out["notes"]:
        records[(kind, ax, "")] = records.get((kind, ax, ""), 0) + b
    res["recv_bytes"] = sum(o - i for op, i, o in out["eqns"] if op.startswith("allgather")
                            or op == "_allgather_base_")
    res["traffic"] = summarize(records)["by_kind"]
    if job["fault"]:
        del params, opt, step, out
        gc.collect()
        torch.cuda.empty_cache()
        undo = plant_fault(job["arch"], rank, job["fault"])
        try:  # the plan is made with the step
            params, opt, step = start()
            params, opt, m = step(params, opt, batches[0])
        finally:
            undo()
        res["fault"] = {"metrics": {k: float(v) for k, v in m.items()},
                        "grad_gaps": _grad_gaps(opt, float(m["clip"]), single, spec_leaves,
                                                mesh),
                        "replicas_agree": replicas(params)}
    res["seconds"] = time.perf_counter() - t_job
    return res


def _sharded_rank(rank: int, world: int, kw: dict) -> dict:
    """One rank of the sharded phase: every job of ``kw["jobs"]`` in turn
    (``_sharded_job``), each freed before the next."""
    import gc

    import torch

    from repro_torch import reduce as R
    from repro_torch.launch import mesh as mesh_lib

    R.set_default_backend("cuda_fused")
    mesh_lib.init_process_group(kw.get("device", "cuda"))
    try:
        jobs = []
        for job in kw["jobs"]:
            jobs.append(_sharded_job(rank, world, job))
            gc.collect()
            torch.cuda.empty_cache()
        return {"jobs": jobs, "peak_gb": max(j["peak_gb"] for j in jobs)}
    finally:
        mesh_lib.shutdown(barrier=False)


def _sharded_single(arch: str, layers: int, probe_path: str) -> dict:
    """The single-rank steps of the phase's config on the same weights and
    batches: each step's loss, grad norm and clip, step 1's routing, and
    step 1's update and gradient (AdamW's first moment over the clip
    coefficient) of the probed leaves (``_probe_leaves``), saved whole at
    f32 to ``probe_path`` by leaf index for the ranks."""
    import dataclasses

    import torch

    from repro_torch import reduce as R
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_train_step

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    params = _sharded_params(cfg, DEVICE)
    for p in R.tree_leaves(params):
        p.requires_grad_(True)
    tcfg = sharded_tcfg(arch)
    opt = sharded_opt(params, cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    probe = _probe_leaves(params, cfg)
    before = {j: R.tree_leaves(params)[j].detach().clone() for j in probe}
    out = {"metrics": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(_sharded_batches(cfg, DEVICE)):
        t0 = time.perf_counter()
        if i == 0:
            (res, routes) = record_routing(lambda: step(params, opt, batch))
        else:
            res = step(params, opt, batch)
        torch.cuda.synchronize()
        params, opt, m = res
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out.update(drops=drop_fractions(routes[:layers]),  # the forward's
                       wall_ms=(time.perf_counter() - t0) * 1e3,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            leaves, clip = R.tree_leaves(params), float(m["clip"])
            torch.save({j: {"update": (leaves[j].detach().float() - before[j].float()).cpu(),
                            "grad": opt.m[j].detach().cpu() / clip} for j in probe}, probe_path)
            del before, routes
    del params, opt, res, m
    torch.cuda.empty_cache()
    return out


def check_cross_entropy_partial(results: dict, gen) -> None:
    """K7's partial variant at deepseek-7b's rank shape on the (2, 2) mesh:
    a rank's rows of a loss chunk (2 x 512) x its 51 200 columns of the
    102 400-column vocabulary, f32, against its plain version; the two
    model ranks' triples merged against K7 over the whole row; timed beside
    its bound and ``torch.logsumexp`` over the slice (the nearest library
    call: no one call gives the partial)."""
    import torch

    from repro_torch.kernels import cross_entropy, cross_entropy_partial
    from repro_torch.kernels.cross_entropy import cross_entropy_partial_plain, merge_partials

    rows, vocab = (TRAIN_BATCH // SHARDED_SHAPE[0]) * LOSS_CHUNK, 102400
    width = vocab // SHARDED_SHAPE[1]
    whole = torch.randn((rows, vocab), generator=gen, device=DEVICE) * 3
    labels = torch.randint(0, vocab, (rows,), generator=gen, device=DEVICE)
    parts, err = [], 0.0
    for r in range(SHARDED_SHAPE[1]):
        x = whole[:, r * width:(r + 1) * width].contiguous()
        before = cross_entropy_partial.launches
        got = cross_entropy_partial(x, labels, r * width)
        check(cross_entropy_partial.launches == before + 1, "cross_entropy_partial: launches")
        want = cross_entropy_partial_plain(x, labels, r * width)
        torch.cuda.synchronize()
        lse = lambda t: t[:, 0] + torch.log(t[:, 1])  # noqa: E731
        err = max(err, float((lse(got) - lse(want)).abs().max()),
                  float((got[:, 2] - want[:, 2]).abs().max()))
        check(torch.equal(got, cross_entropy_partial(x, labels, r * width)),
              "cross_entropy_partial: a repeat differs")
        parts.append(got)
    merged, _ = merge_partials(parts)
    full = cross_entropy(whole, labels)
    d_full = float((merged - full).abs().max())
    print(f"K7 partial ({rows}, {width}) f32 at col0 0 and {width} (deepseek-7b's rank shape "
          f"on (2, 2)): max_abs_err {err:.3g} in the slice's logsumexp and pick vs plain (tol "
          f"1e-3, K7's); the two slices merged vs K7 over the whole {vocab} columns: max |d| "
          f"{d_full:.3g} (tol 1e-4: the same 2048-column slices, merged in another order)")
    check(err <= 1e-3, "cross_entropy_partial disagrees with its plain version")
    check(d_full <= 1e-4, "cross_entropy_partial: the merged slices are off K7's loss")
    x = whole[:, :width].contiguous()
    n = x.numel()
    b, by = bound_ms(n * 4 + rows * 4 + rows * 12, tensor_flops=16 * n, core_flops=4 * n)
    results["cross_entropy_partial"] = {
        "max_abs_err": err,
        "ms": device_ms(lambda: cross_entropy_partial(x, labels, 0), "::ce_kernel<"),
        "call_ms": time_ms(lambda: cross_entropy_partial(x, labels, 0), iters=20),
        "plain_ms": device_ms(lambda: cross_entropy_partial_plain(x, labels, 0), iters=3),
        "bound_ms": b, "bound_by": by,
        "library_ms": device_ms(lambda: torch.logsumexp(x, -1)),
        "merged_vs_full_max_abs": d_full,
    }


def sharded_update_gaps(ranks) -> dict:
    """Per probed leaf, the ranks' block sums added: ``gap`` =
    ||sharded - single|| / ||single|| of step 1's update, ``flipped`` the
    same with the sharded update negated, ``moved`` whether the single
    rank's update moved the leaf (without it, ``gap`` is 0 when the sharded
    update left it alone too, else inf)."""
    sums = {}
    for res in ranks:
        for j, *terms in res["update"]:
            acc = sums.setdefault(j, [0.0] * 4)
            for k, v in enumerate(terms):
                acc[k] += v
    out = {}
    for j, (diff, ref, flip, mine) in sums.items():
        if ref > 0:
            out[j] = {"moved": True, "gap": math.sqrt(diff / ref), "flipped": math.sqrt(flip / ref)}
        else:
            out[j] = {"moved": False, "gap": 0.0 if mine == 0 else math.inf, "flipped": math.inf}
    return out


def _check_sharded_arch(arch: str, layers: int, shape, ranks: list, single: dict,
                        planted=True) -> dict:
    """The checks of one arch of the sharded phase (``run_sharded_phase``)
    on its ranks' results against the single rank's; returns the dry run's
    collectives summary. ``planted``: the fault the ranks planted
    (``plant_fault``)."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.parallel import Plan

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    mesh = abstract_mesh(shape, SHARDED_AXES)
    specs = sharded_specs(cfg, SHARDED_RULES[arch], mesh)
    model = dryrun.summarize(dryrun.step_collectives(
        cfg, TrainConfig(), mesh, specs, (TRAIN_BATCH, TRAIN_SEQ + 1)))
    want_launches = sharded_launches_per_step(cfg, Plan(cfg, mesh, specs).vocab_parallel)
    one = single["metrics"][0]
    mesh_name = f"(data {shape[0]}, model {shape[1]})"
    print(f"sharded {arch} at {layers} of {get_arch(arch).n_layers} layers "
          f"({SHARDED_RULES[arch]}, {mesh_name}, {len(ranks)} ranks on one card over "
          f"{ranks[0]['transport']}): single-rank step 1 loss {one['loss']!r}, grad norm "
          f"{one['grad_norm']!r}, clip {one['clip']!r}, wall {single['wall_ms']:.1f} ms, "
          f"peak {single['peak_gb']:.2f} GB")
    for r, res in enumerate(ranks):
        m = res["metrics"][0]
        print(f"sharded {arch} rank {r}: step 1 loss {m['loss']!r}, grad norm "
              f"{m['grad_norm']!r}, clip {m['clip']!r}; step walls "
              f"{[round(w, 1) for w in res['wall_ms']]} ms; c10d bytes in {res['recv_bytes']} "
              f"(dry run {model['total_bytes']}), by kind {res['traffic']}; peak "
              f"{res['peak_gb']:.2f} GB (the fit check's model "
              f"{res['model_gb']:.2f} GB with the reserve); replicas bitwise "
              f"{res['replicas_agree']}; launches {res['launches']}; {res['seconds']:.1f} s")
        check(res["transport"] == "gloo" and res["device"] == "cuda:0",
              f"sharded {arch}: rank {r} did not share card 0 over gloo")
        check(res["metrics"] == ranks[0]["metrics"], f"sharded {arch}: the ranks' metrics differ")
        check(res["replicas_agree"], f"sharded {arch}: replicated leaves differ across ranks")
        check(res["recv_bytes"] == model["total_bytes"] and res["traffic"] == model["by_kind"],
              f"sharded {arch}: rank {r}'s collective bytes are off the dry run's")
        for k, n in want_launches.items():
            check(res["launches"][k] == n,
                  f"sharded {arch}: {k}: {res['launches'][k]} launches, expected {n}")
        check(res["peak_gb"] <= res["model_gb"],
              f"sharded {arch}: rank {r}'s peak is past the fit check's model")
        check(all(math.isfinite(v) for mm in res["metrics"] for v in mm.values()),
              f"sharded {arch}: non-finite metrics")
    for i, (got, want) in enumerate(zip(ranks[0]["metrics"], single["metrics"]), 1):
        rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm", "clip")}
        print(f"sharded {arch} step {i} against the single-rank step: loss {got['loss']!r} vs "
              f"{want['loss']!r}, rel. {rel['loss']:.3g} (tol {SHARDED_LOSS_REL}); grad norm "
              f"rel. {rel['grad_norm']:.3g}, clip rel. {rel['clip']:.3g} (tol "
              f"{SHARDED_GRAD_REL})")
        check(rel["loss"] <= SHARDED_LOSS_REL, f"sharded {arch}: step-{i} loss off the single rank")
        check(rel["grad_norm"] <= SHARDED_GRAD_REL and rel["clip"] <= SHARDED_GRAD_REL,
              f"sharded {arch}: step-{i} grad norm or clip off the single rank")
    check(len(single["metrics"]) == SHARDED_STEPS == len(ranks[0]["metrics"]),
          f"sharded {arch}: steps missing")
    gaps = sharded_update_gaps(ranks)
    moved = [g for g in gaps.values() if g["moved"]]
    worst = max(g["gap"] for g in moved)
    flipped = min(g["flipped"] for g in moved)
    print(f"sharded {arch} step 1's update of {len(gaps)} probed leaves ({len(moved)} moved) "
          f"against the single rank's: worst ||sharded - single|| / ||single|| {worst:.4g} (tol "
          f"{SHARDED_UPDATE_REL}; a flipped update would read {flipped:.4g}); leaves left alone "
          f"by both: {all(g['moved'] or g['gap'] == 0 for g in gaps.values())}")
    check(moved and worst <= SHARDED_UPDATE_REL < flipped,
          f"sharded {arch}: step 1's update off the single rank's")
    check(all(g["moved"] or g["gap"] == 0 for g in gaps.values()),
          f"sharded {arch}: a leaf the single rank left alone moved")
    grad = max(g for res in ranks for _, g in res["grad_gaps"])
    print(f"sharded {arch} step 1's gradient of the probed leaves against the single rank's: "
          f"worst ||sharded - single|| / ||single|| a leaf and rank {grad:.4g}"
          + (f" (tol {SHARDED_LEAF_GRAD_REL})" if arch in SHARDED_MIXERS else ""))
    out = {"model": model, "grad_gap": grad}
    if arch in SHARDED_MIXERS:
        check(grad <= SHARDED_LEAF_GRAD_REL, f"sharded {arch}: step 1's gradient off the single "
              "rank's")
        fault = max(g for res in ranks for _, g in res["fault"]["grad_gaps"])
        agree = [res["fault"]["replicas_agree"] for res in ranks]
        print(f"sharded {arch} with {fault_name(arch, planted)}: "
              f"worst gradient gap {fault:.4g}, {fault / SHARDED_LEAF_GRAD_REL:.3g} x the limit "
              f"(at least {SHARDED_FAULT_X} needed); replicas bitwise {agree}")
        # not a check: step 1's AdamW update is lr x the gradient's sign,
        # which a doubled gradient keeps, and most bf16 weights do not move
        # by it, so the replicas may stay equal
        check(fault >= SHARDED_FAULT_X * SHARDED_LEAF_GRAD_REL,
              f"sharded {arch}: the planted fault does not read {SHARDED_FAULT_X} x the limit")
        out["fault_gap"] = fault
    if get_arch(arch).moe is not None:
        # ranks (d, 0) and (d, 1) route the same rows; the two data
        # groups' rows together are the single rank's batch
        d0, d1 = ranks[0]["drops"], ranks[2]["drops"]
        check(ranks[1]["drops"] == d0 and ranks[3]["drops"] == d1,
              f"sharded {arch}: the model ranks of a data group routed differently")
        merged = [(a + b) / 2 for a, b in zip(d0, d1)]
        gap = max(abs(a - b) for a, b in zip(merged, single["drops"]))
        print(f"sharded {arch}: moe_drop_frac over the global batch, mean "
              f"{sum(merged) / len(merged):.4f} (single rank "
              f"{sum(single['drops']) / len(single['drops']):.4f}), largest gap a layer "
              f"{gap:.4g} (tol {SHARDED_DROP_TOL})")
        check(len(merged) == layers and gap <= SHARDED_DROP_TOL,
              f"sharded {arch}: drop fractions off the single rank's")
    return out


def run_sharded_phase(results: dict, gen) -> dict:
    """The sharded step on the card, four gloo ranks sharing the first card
    in one spawn that runs every arch in turn: (a) deepseek-7b at full
    width under DEFAULT_RULES (FSDP + TP + vocab TP) on (data 2, model 2),
    cut to the deepest depth the sharded fit check accepts for four ranks
    and the single-rank check for its reference (``sharded_cut_depth``),
    capped at ``SHARDED_DEEPSEEK_LAYERS``; (b) granite-moe-1b-a400m at full
    width and ``SHARDED_GRANITE_LAYERS`` layers under SMALL_MODEL_RULES
    (FSDP + vocab TP + EP, 16 experts a rank); (c) minicpm3-4b (MLA),
    llama-3.2-vision-11b (cross-attention, its (4, 1032, 4096) context),
    recurrentgemma-9b (RG-LRU and local attention) and mamba2-780m (the
    SSM) at full width under DEFAULT_RULES, and musicgen-medium (codebook
    streams, the fused second moment) under SMALL_MODEL_RULES, at the
    depths and on the meshes of ``SHARDED_MIXERS``.
    Each: ``SHARDED_STEPS`` steps of 4 x 512 tokens; every step's loss,
    grad norm and clip against the single-rank step on the same weights
    and batches (run before the ranks, never beside them), step 1's update
    of the probed leaves against the single rank's
    (``SHARDED_UPDATE_REL``); replicated leaves bitwise equal across ranks;
    the metered c10d bytes and the noted traffic of step 1 equal to the dry
    run's model (``launch.dryrun.step_collectives``); the launches per rank
    equal ``sharded_launches_per_step``; the peak beside the fit check's
    model; for (c) step 1's gradient of the probed leaves
    (``SHARDED_LEAF_GRAD_REL``) and a planted fault in the new kind
    (``plant_fault``) that must read ``SHARDED_FAULT_X`` times that
    limit. Then K7's partial variant against its plain version
    (``check_cross_entropy_partial``), and (d) the dry run of deepseek-7b
    train_4k on (2, 2) and on the production (16, 16): a rank's bytes (a
    model figure). Returns rank 0's launches of (a), its main path."""
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    t_phase = time.time()
    jobs = []
    for arch in SHARDED_ARCHS:
        shape = SHARDED_SHAPE
        if arch == GRANITE:
            layers = min(get_arch(arch).n_layers, SHARDED_GRANITE_LAYERS)
        elif arch == "deepseek-7b":
            layers = min(sharded_cut_depth(arch), SHARDED_DEEPSEEK_LAYERS)
        else:
            layers, shape = SHARDED_MIXERS[arch]
            check(sharded_fits(arch, layers, shape),
                  f"sharded {arch} at {layers} layers does not fit the card on {shape}")
        jobs.append({"arch": arch, "layers": layers, "shape": shape,
                     "rules": SHARDED_RULES[arch], "fault": arch in SHARDED_MIXERS})
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        singles = {}
        for job in jobs:
            t0 = time.time()
            job["probe"] = os.path.join(tmp, f"{job['arch']}_single.pt")
            singles[job["arch"]] = _sharded_single(job["arch"], job["layers"], job["probe"])
            print(f"sharded {job['arch']}: the single rank's steps {time.time() - t0:.1f} s")
        ranks = spawn_ranks("sharded", SHARDED_WORLD, jobs=jobs, one_card=True)
    for i, job in enumerate(jobs):
        arch = job["arch"]
        arch_ranks = [r["jobs"][i] for r in ranks]
        out[arch] = dict(_check_sharded_arch(arch, job["layers"], job["shape"], arch_ranks,
                                             singles[arch]),
                         layers=job["layers"], shape=job["shape"], ranks=arch_ranks,
                         single=singles[arch])
    torch.cuda.empty_cache()
    check_cross_entropy_partial(results, gen)
    for mesh_name in ("2x2", "single"):
        rec = dryrun.run_cell("deepseek-7b", "train_4k", mesh_name)
        print("dry run (a model figure, nothing allocated): " + dryrun.describe(rec))
        check(rec["status"] == "ok", f"dry run of deepseek-7b train_4k on {mesh_name} failed")
        out[f"dryrun_{mesh_name}"] = rec["bytes_per_rank"]
    print(f"sharded phase: {time.time() - t_phase:.1f} s")
    out["launches"] = out["deepseek-7b"]["ranks"][0]["launches"]
    return out


# ------------- sharded serving: prefill and decode over (data, model) -------------

# Each arch of the sharded serving phase: the reference's serving rules for
# it (``dryrun.rules_for(cfg, "serve")``), its depth (None: all of it) and
# its prompts' length. granite at full depth; deepseek-7b at 3 of 30 layers
# (at 30 the whole script took 1002.3 s, PERF.md section 6; 8 until the
# uneven-heads phase joined the script); the MLA, SSM, RG-LRU,
# cross-attention and codebook archs at full width, each at the least
# depth that holds every block kind of its pattern (minicpm3-4b at 1 layer,
# 2 until the uneven-heads phase; mamba2-780m at 4 layers),
# recurrentgemma's prompts past its window of 2048 so that the ring it
# cuts by slots wraps over the cut.
SERVE_SHARDED = {"deepseek-7b": ("TP_ONLY_RULES", 3, PROMPT),
                 GRANITE: ("SMALL_MODEL_RULES", None, PROMPT),
                 MINICPM: ("TP_ONLY_RULES", 1, PROMPT),
                 MAMBA: ("SMALL_MODEL_RULES", 4, PROMPT),
                 RG: ("TP_ONLY_RULES", 3, RING_PROMPT),
                 VISION: ("TP_ONLY_RULES", 5, PROMPT),
                 MUSICGEN: ("SMALL_MODEL_RULES", 2, PROMPT)}
SERVE_SHARDED_STEPS, SERVE_SHARDED_SEED = 16, 2
# The sharded logits against the single rank's on the same card, weights
# and tokens, both bf16 on the kernels: a tensor of logits (the prefill's
# last token, or one decode step's) at a time, max |sharded - single| over
# max |single|. The ranks add their partial products (o, down, the
# experts' combine) in bf16 in another order than the whole product, and
# from there the two runs part by bf16's own error: on an H100
# (tools/serve_gap_probe.py, PERF.md section 6) each sits as far from the
# same weights run in f32 as the other (single / sharded: deepseek-7b
# 0.0190 / 0.0217, granite 0.0500 / 0.0499), granite's routers pick
# another expert set for 7-9% of (token, layer) between the two, and they
# read 0.0276 and 0.0442 apart. At f32 the two agree to 6.7e-6 and 1.0e-6.
SERVE_SHARDED_REL = 0.05
# The planted fault: model rank 1's fixed-order all-reduce returns twice its
# own partial in place of the ranks' sum (a fold that desynced), and its
# block of every serving gather (``models.parallel.Serve.gather``: the
# head outputs, the SSM's conv outputs and y, the RG-LRU's products) adds
# its neighbour channel's value, in one extra prefill: the archs served
# under SMALL_MODEL_RULES have no all-reduce past the vocabulary lookup,
# whose fault the next norm mostly cancels. It must read at least this
# many times the limit.
SERVE_SHARDED_FAULT_X = 10
# The sharding's own error, which bf16's hides: the same weights upcast to
# f32 on the plain route with the attention's bf16 operand rounding off,
# the prefill and SERVE_F32_STEPS decode steps against the single rank's
# f32 run. Limit 1e-4 (the probe's readings 15-100 times under it), and a
# small fault that must read SERVE_SHARDED_FAULT_X times over it: model
# rank 1's all-reduce returns the sum plus SERVE_SMALL_FAULT of its own
# partial (one bf16 ulp), and its gathered blocks SERVE_SMALL_FAULT of
# their neighbour channel's value.
SERVE_F32_REL, SERVE_F32_STEPS, SERVE_SMALL_FAULT = 1e-4, 1, 2.0 ** -8


def _serve_cfg(arch: str, spec=None):
    """``arch`` cut to its depth in the sharded serving phase (``spec``:
    (rules, depth, prompt length), ``SERVE_SHARDED``'s by default)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    layers = (spec or SERVE_SHARDED[arch])[1]
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def _serve_prompts(cfg, device, prompt: int):
    """``SLOTS`` seeded prompts of ``prompt`` tokens ((SLOTS, prompt, K) with
    K codebook streams), and a cross-attention arch's context: one
    synthetic image a prompt (``frontends.synth_image_embeds``, seeded 1),
    else None."""
    import torch

    from repro_torch.models.frontends import synth_image_embeds

    gen = torch.Generator(device=device).manual_seed(SERVE_SHARDED_SEED)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompts = torch.randint(0, cfg.vocab_size, (SLOTS, prompt) + books, generator=gen,
                            device=device)
    ctx = None
    if cfg.n_img_tokens:
        ctx = synth_image_embeds(torch.Generator(device=device).manual_seed(1), SLOTS,
                                 cfg.n_img_tokens, cfg.d_model, torch.bfloat16, device)
    return prompts, ctx


def _rel_gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _f32_cfg(cfg):
    """The f32 route of the sharded serving phase's second check."""
    return dataclasses.replace(cfg, dtype="float32", use_kernels=False, mma_reductions=False)


def _upcast(params):
    from repro_torch.launch.sharding import tree_map

    return tree_map(lambda t: t.float() if t.is_floating_point() else t, params)


@contextlib.contextmanager
def _f32_route():
    """The process's settings for the f32 route: the plain reductions (no
    process default) and the attention's bf16 operand rounding off; the
    phase's ``cuda_fused`` default and the rounding after."""
    from repro_torch import reduce as R
    from repro_torch.models import attention

    real = attention.bf16_round
    R.set_default_backend(None)
    attention.bf16_round = lambda x: x
    try:
        yield
    finally:
        attention.bf16_round = real
        R.set_default_backend("cuda_fused")


def serving_single(arch: str, path: str, spec=None) -> dict:
    """The single rank's prefill of ``SLOTS`` prompts (``SERVE_SHARDED``'s
    length, or ``spec``'s; a cross-attention arch's context beside them) and
    ``SERVE_SHARDED_STEPS`` greedy decode steps on the phase's weights (the
    seed of the sharded step's phase, the cross-attention gates opened to
    ``OPEN_GATE``), saved to ``path`` for the ranks: the prompts and the
    context, the prefill's logits, each step's input tokens and logits
    (the teacher-forced inputs of the ranks), and the f32 route's logits
    of the prefill and ``SERVE_F32_STEPS`` decode steps on the same values
    upcast; its prefill ms and decode ms a token (host clock, the card
    synchronised)."""
    import torch

    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_params

    cfg = _serve_cfg(arch, spec)
    prompt = (spec or SERVE_SHARDED[arch])[2]
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SHARDED_SEED), DEVICE)
    open_gates(params, OPEN_GATE)
    prefill = make_prefill_step(cfg, prompt + SERVE_SHARDED_STEPS)
    decode = make_decode_step(cfg, greedy=False)
    prompts, ctx = _serve_prompts(cfg, DEVICE, prompt)
    out = {"prompts": prompts.cpu(), "ctx": None if ctx is None else ctx.cpu(), "tokens": [],
           "steps": []}
    with torch.inference_mode():
        prefill(params, prompts, ctx)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, prompts, ctx)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out["prefill"] = logits.cpu()
        tok = torch.argmax(logits, -1).to(torch.int32)
        t0 = time.perf_counter()
        for i in range(SERVE_SHARDED_STEPS):
            out["tokens"].append(tok.cpu())
            lg, caches = decode(params, caches, tok, prompt + i)
            out["steps"].append(lg.cpu())  # synchronises
            tok = torch.argmax(lg, -1).to(torch.int32)
        decode_ms = (time.perf_counter() - t0) * 1e3 / SERVE_SHARDED_STEPS
    del caches, logits, lg
    params = _upcast(params)  # the bf16 values, freed
    torch.cuda.empty_cache()
    f32 = _f32_cfg(cfg)
    with torch.inference_mode(), _f32_route():
        logits, caches = make_prefill_step(f32, prompt + SERVE_SHARDED_STEPS)(
            params, prompts, None if ctx is None else ctx.float())
        out["f32"] = [logits.cpu()]
        decode = make_decode_step(f32, greedy=False)
        for i in range(SERVE_F32_STEPS):
            lg, caches = decode(params, caches, out["tokens"][i].to(DEVICE), prompt + i)
            out["f32"].append(lg.cpu())
    torch.save(out, path)
    del params, caches, logits, lg
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms}


def _desync_model_rank(mesh, small=None):
    """On model rank 1 of each data group the fixed-order all-reduce
    (``sum_forward``) returns twice the rank's own partial in place of the
    ranks' sum (with ``small``, the sum plus ``small`` times its own
    partial), and the block it gives to a serving gather (``Serve.gather``)
    adds its neighbour channel's value (``small`` times it); it still joins
    every collective, so no rank waits. Returns the undo."""
    from repro_torch.core import collectives as coll
    from repro_torch.models import parallel

    real, real_gather = coll._SumForward.forward, parallel.Serve.gather
    faulty = mesh.axis_index("model") == 1

    def wrong(ctx, x, axes, mesh):
        out = real(ctx, x, axes, mesh)
        if not faulty:
            return out
        return x + x if small is None else out + small * x

    def wrong_gather(self, x, dim, sizes=None):
        if faulty:
            x = x + (1.0 if small is None else small) * x.roll(1, -1)
        return real_gather(self, x, dim, sizes)

    coll._SumForward.forward = staticmethod(wrong)
    parallel.Serve.gather = wrong_gather

    def undo():
        coll._SumForward.forward = staticmethod(real)
        parallel.Serve.gather = real_gather

    return undo


def _serve_arch_on_rank(rank: int, world: int, mesh, arch: str, single_path: str, spec=None,
                        o_rows: bool = False) -> dict:
    """One arch of the sharded serving phase on this rank: the weights drawn
    whole on the card and cut to the rank's blocks one rank at a time; the
    sharded prefill (metered: launches, c10d ops, traffic) and its second
    run bitwise; ``SERVE_SHARDED_STEPS`` decode steps teacher-forced with
    the single rank's tokens, each run for its logits and again for its
    greedy token (step 1 metered, and retried: logits and caches bitwise);
    every gap against the single rank's logits; a prefill with the planted
    fault. Then the blocks upcast to f32: the prefill and
    ``SERVE_F32_STEPS`` decode steps on the f32 route against the single
    rank's, and a prefill with the small fault. With ``o_rows`` the planted
    fault is ``plant_o_rows`` at bf16 and at f32 alike. ``spec``: (rules,
    depth, prompt length), ``SERVE_SHARDED``'s by default."""
    import torch
    import torch.distributed as dist

    from repro_torch import reduce as R
    from repro_torch.core import collectives as C
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_params
    from repro_torch.reduce import inspect

    t_arch = time.perf_counter()
    cfg = _serve_cfg(arch, spec)
    rules, _, prompt = spec or SERVE_SHARDED[arch]

    def plant(small):
        return plant_o_rows(dist.get_rank()) if o_rows else _desync_model_rank(mesh, small)

    specs = sharded_specs(cfg, rules, mesh)
    dev = mesh.device
    for r in range(world):  # one whole model on the card at a time
        if r == rank:
            full = init_params(cfg, torch.Generator(device=dev).manual_seed(SHARDED_SEED), dev)
            open_gates(full, OPEN_GATE)
            params = SH.shard_tree(full, specs, mesh)
            del full
            torch.cuda.empty_cache()
        dist.barrier()
    ref = torch.load(single_path)
    s_max = prompt + SERVE_SHARDED_STEPS
    prefill = make_prefill_step(cfg, s_max, mesh=mesh, param_shardings=specs)
    decode = make_decode_step(cfg, greedy=False, mesh=mesh, param_shardings=specs)
    greedy = make_decode_step(cfg, greedy=True, mesh=mesh, param_shardings=specs)
    prompts = ref["prompts"].to(dev)
    ctx = None if ref["ctx"] is None else ref["ctx"].to(dev)
    d, n = mesh.axis_index("data"), SLOTS // mesh.axis_size("data")
    rows = slice(d * n, (d + 1) * n)
    res = {}

    def metered(name, fn):
        def go():
            with C.traffic() as notes:
                eqns = inspect.collective_eqns(lambda: res.update(out=fn()))
            kinds = {}
            for kind, _, b in notes:
                kinds[kind] = kinds.get(kind, 0) + b
            res[f"{name}_by_kind"] = kinds
            res[f"{name}_c10d"] = sum(o - i for op, i, o in eqns if op.startswith("allgather")
                                      or op == "_allgather_base_")

        _, res[f"{name}_launches"] = counted_run(go)
        return res.pop("out")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, caches = metered("prefill", lambda: prefill(params, prompts, ctx))
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    again, caches2 = prefill(params, prompts, ctx)  # a second prefill beside the first: not peaked
    torch.cuda.synchronize()
    res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    res["prefill_bitwise"] = bool(torch.equal(logits, again))
    del again, caches2
    torch.cuda.reset_peak_memory_stats()
    res["prefill_gap"] = _rel_gap(logits.cpu(), ref["prefill"][rows])
    agree = bool(C.replica_bits_agree(logits, ("model",), mesh))
    gaps, kept, excluded, walls, equal = [], 0, 0, [], True
    for i in range(SERVE_SHARDED_STEPS):
        tok, pos = ref["tokens"][i].to(dev), prompt + i
        # each step runs from the committed caches (``pre``): the recurrent
        # caches are new tensors a step, the KV and latent caches' in-place
        # write of the step's slot repeats bitwise, so the retry and the
        # greedy run of the same step see the state the first run saw
        pre = caches
        if i == 0:
            lg, caches = metered("decode", lambda: decode(params, pre, tok, pos))
            after = [t.cpu() for t in R.tree_leaves(caches)]
            lg2, caches = decode(params, pre, tok, pos)
            res["retry_bitwise"] = bool(torch.equal(lg, lg2)) and all(
                torch.equal(a, b.cpu()) for a, b in zip(after, R.tree_leaves(caches)))
            nxt, caches = metered("greedy", lambda: greedy(params, pre, tok, pos))
        else:
            lg, caches = decode(params, pre, tok, pos)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nxt, caches = greedy(params, pre, tok, pos)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        agree &= bool(C.replica_bits_agree(lg, ("model",), mesh))
        want = ref["steps"][i][rows]
        mine = lg.cpu()
        gaps.append(_rel_gap(mine, want))
        equal &= bool(torch.equal(nxt.cpu(), torch.argmax(mine, -1).to(torch.int32)))
        vocab = want.shape[-1]
        # the single rank's token where its margin is clear, a row (and a
        # codebook stream) at a time
        for w_row, m_row, tok_j in zip(want.reshape(-1, vocab), mine.reshape(-1, vocab),
                                       nxt.cpu().reshape(-1)):
            top = torch.topk(w_row.double(), 2).values
            row_gap = float((m_row.double() - w_row.double()).abs().max())
            if float(top[0] - top[1]) > 2 * row_gap:
                kept += 1
                res.setdefault("token_misses", 0)
                res["token_misses"] += int(int(tok_j) != int(torch.argmax(w_row)))
            else:
                excluded += 1
    res["peak_gb"] = max(peak, torch.cuda.max_memory_allocated()) / 1e9
    undo = plant(None)
    try:
        faulty, _ = prefill(params, prompts, ctx)
    finally:
        undo()
    res.update(step_gaps=gaps, decode_ms=sum(walls) / len(walls), greedy_is_argmax=equal,
               tokens_checked=kept, tokens_excluded=excluded, replicas_agree=agree,
               fault_gap=_rel_gap(faulty.cpu(), ref["prefill"][rows]),
               token_misses=res.get("token_misses", 0))
    del caches, logits, faulty
    for r in range(world):  # the blocks upcast one rank at a time, the bf16 ones freed
        if r == rank:
            params = _upcast(params)
            torch.cuda.empty_cache()
        dist.barrier()
    f32 = _f32_cfg(cfg)
    prefill = make_prefill_step(f32, s_max, mesh=mesh, param_shardings=specs)
    decode = make_decode_step(f32, greedy=False, mesh=mesh, param_shardings=specs)
    ctx = None if ctx is None else ctx.float()
    with _f32_route():
        logits, caches = prefill(params, prompts, ctx)
        res["f32_gaps"] = [_rel_gap(logits.cpu(), ref["f32"][0][rows])]
        for i in range(SERVE_F32_STEPS):
            lg, caches = decode(params, caches, ref["tokens"][i].to(dev), prompt + i)
            res["f32_gaps"].append(_rel_gap(lg.cpu(), ref["f32"][i + 1][rows]))
        undo = plant(SERVE_SMALL_FAULT)
        try:
            faulty, _ = prefill(params, prompts, ctx)
        finally:
            undo()
    res["f32_fault_gap"] = _rel_gap(faulty.cpu(), ref["f32"][0][rows])
    del params, caches, logits, lg, faulty
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_arch
    return res


def _serving_rank(rank: int, world: int, kw: dict) -> dict:
    """One rank of the sharded serving phase: a (2, 2) mesh of ranks
    sharing the first card over gloo, each arch of ``kw["archs"]`` in
    turn (``_serve_arch_on_rank``)."""
    from repro_torch import reduce as R
    from repro_torch.launch import mesh as mesh_lib

    R.set_default_backend("cuda_fused")
    mesh_lib.init_process_group(kw.get("device", "cuda"))
    try:
        mesh = mesh_lib.make_mesh(SHARDED_SHAPE, SHARDED_AXES)
        out = {arch: _serve_arch_on_rank(rank, world, mesh, arch, path)
               for arch, path in kw["archs"]}
        out.update(transport=mesh.backend, device=str(mesh.device))
        return out
    finally:
        mesh_lib.shutdown(barrier=False)


def serving_launches(cfg) -> dict:
    """A rank's launches in one sharded prefill or decode step: the block
    norms and the final norm (``_layer_launches``: K5b; K5a for a
    non-parametric LayerNorm, none for musicgen's LayerNorm with scale and
    bias), K6 once a self-attention block in the prefill only (on the
    rank's heads; past heads of 128 its wide variant; none for MLA and
    cross-attention); nothing else (the MLA, SSM and RG-LRU mixers launch
    no kernel)."""
    norms, attn = _layer_launches(cfg)
    decode = {k: v for k, v in _norm_kernels(cfg, norms + 1).items() if v}
    return {"prefill": dict(decode, **({"flash_attention": attn} if attn else {})),
            "decode": decode}


def run_sharded_serving_phase() -> dict:
    """Sharded serving on the card (``launch.steps.make_prefill_step`` and
    ``make_decode_step`` with ``mesh=``): four gloo ranks sharing the first
    card on (data 2, model 2) serve each arch of ``SERVE_SHARDED`` at full
    width: deepseek-7b at 3 layers under TP_ONLY_RULES (heads cut; K6 and
    K5b in the prefill on the rank's heads), granite-moe-1b-a400m at full
    depth under SMALL_MODEL_RULES (weights whole over "model", FSDP over
    "data", EP; caches cut by heads), minicpm3-4b (MLA's heads cut, its
    latent by slots: the split-KV decode in latent space), mamba2-780m
    under SMALL_MODEL_RULES (the state cut by heads, the conv cache by
    channels), recurrentgemma-9b (the RG-LRU's channels, the local
    attention's one-kv-head ring cut by slots past the window: K6 wide on
    the rank's 8 of 16 heads), llama-3.2-vision-11b (cross-attention cut
    by kv heads, the gates open) and musicgen-medium under
    SMALL_MODEL_RULES (the codebook streams), ``SLOTS`` prompts each and
    ``SERVE_SHARDED_STEPS`` decode steps. Each is held to the single
    rank on the same card and weights, run before the ranks: the
    prefill's last-token logits and every teacher-forced decode step's
    within ``SERVE_SHARDED_REL``, the planted fault at least
    ``SERVE_SHARDED_FAULT_X`` times over it, and the same weights at f32
    on the plain route within ``SERVE_F32_REL``, a small fault at least as
    many times over that; the greedy token equal to the
    single rank's where that rank's top-2 margin is more than twice the
    row's gap (and always to the argmax of the rank's own logits); a
    retried decode step bitwise; the c10d bytes of the prefill and of a
    decode step equal to the dry run's serving cell at this depth and
    batch; the launches to ``serving_launches``; the peak of a rank under
    the dry run's bytes. Returns rank 0's launches by arch."""
    import tempfile

    t_phase = time.time()
    archs = tuple(SERVE_SHARDED)
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        paths = [(arch, os.path.join(tmp, f"{arch}.pt")) for arch in archs]
        single = {arch: serving_single(arch, path) for arch, path in paths}
        ranks = spawn_ranks("serving", SHARDED_WORLD, archs=paths, one_card=True)
    for r, res in enumerate(ranks):
        check(res["transport"] == "gloo" and res["device"] == "cuda:0",
              f"sharded serving: rank {r} did not share card 0 over gloo")
    for arch in archs:
        out[arch] = _check_serving_arch(arch, SERVE_SHARDED[arch], SHARDED_SHAPE,
                                        [res[arch] for res in ranks], single[arch],
                                        ranks[0]["transport"])
    print(f"sharded serving phase: {time.time() - t_phase:.1f} s")
    # rank 0's metered calls: the prefill, a decode step for its logits and
    # one for its greedy token
    out["launches"] = {arch: {k: sum(out[arch]["ranks"][0][f"{m}_launches"].get(k, 0)
                                     for m in ("prefill", "decode", "greedy"))
                              for k in out[arch]["ranks"][0]["prefill_launches"]}
                       for arch in archs}
    return out


def _check_serving_arch(arch: str, spec, shape, ranks: list, one: dict, transport: str) -> dict:
    """The checks of one arch of sharded serving on its ranks' results
    (``_serve_arch_on_rank``) against the single rank's (``one``): ``spec``
    (rules, depth, prompt length) on a ``shape`` mesh (the docstring of
    ``run_sharded_serving_phase``). Returns the arch's record."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh

    mesh = abstract_mesh(shape, SHARDED_AXES)
    cfg = _serve_cfg(arch, spec)
    rules, _, prompt = spec
    s_max = prompt + SERVE_SHARDED_STEPS
    specs = sharded_specs(cfg, rules, mesh)
    models = {"prefill": dryrun.serve_collectives(cfg, mesh, specs, "prefill", SLOTS, prompt,
                                                  s_max=s_max),
              "decode": dryrun.serve_collectives(cfg, mesh, specs, "decode", SLOTS, s_max,
                                                 greedy=False),
              "greedy": dryrun.serve_collectives(cfg, mesh, specs, "decode", SLOTS, s_max)}
    need = dryrun.serve_rank_bytes(cfg, mesh, specs, "prefill", SLOTS, prompt,
                                   s_max=s_max)["need"]
    launches = serving_launches(cfg)
    print(f"sharded serving {arch} ({rules}, {cfg.n_layers} layers, (data {shape[0]}, model "
          f"{shape[1]}), {len(ranks)} ranks on one card over {transport}): single rank prefill "
          f"{one['prefill_ms']:.1f} ms, decode {one['decode_ms']:.2f} ms a token ({SLOTS} x "
          f"{prompt} prompts, {s_max} cache slots)")
    for r, a in enumerate(ranks):
        print(f"sharded serving {arch} rank {r}: {a['wall_s']:.1f} s in all; prefill "
              f"{a['prefill_ms']:.1f} ms, decode {a['decode_ms']:.2f} ms a token (greedy "
              f"step); c10d bytes in: prefill "
              f"{a['prefill_c10d']} (dry run {sum(models['prefill'].values())}), a decode "
              f"step {a['greedy_c10d']} greedy / {a['decode_c10d']} with logits (dry run "
              f"{sum(models['greedy'].values())} / {sum(models['decode'].values())}); "
              f"peak {a['peak_gb']:.3f} GB (dry run {need / 1e9:.3f}); prefill gap "
              f"{a['prefill_gap']:.4g}, decode gaps max {max(a['step_gaps']):.4g} (limit "
              f"{SERVE_SHARDED_REL}); planted fault {a['fault_gap']:.4g}; at f32 gaps "
              f"{[float(f'{g:.4g}') for g in a['f32_gaps']]} (limit {SERVE_F32_REL}), the "
              f"f32 planted fault {a['f32_fault_gap']:.4g}; tokens checked "
              f"{a['tokens_checked']}, excluded by the margin {a['tokens_excluded']}, "
              f"missed {a['token_misses']}; launches prefill "
              f"{ {k: v for k, v in a['prefill_launches'].items() if v} }, decode step "
              f"{ {k: v for k, v in a['greedy_launches'].items() if v} }")
        for mode, model in models.items():
            kinds = {}
            for (kind, _, _), b in model.items():
                kinds[kind] = kinds.get(kind, 0) + b
            check(a[f"{mode}_c10d"] == sum(model.values()) and a[f"{mode}_by_kind"] == kinds,
                  f"sharded serving {arch}: rank {r}'s {mode} collective bytes are off the "
                  "dry run's")
        for mode in ("prefill", "decode", "greedy"):
            got = {k: v for k, v in a[f"{mode}_launches"].items() if v}
            check(got == launches["prefill" if mode == "prefill" else "decode"],
                  f"sharded serving {arch}: {mode} launches {got}, off the launch model")
        check(a["prefill_gap"] <= SERVE_SHARDED_REL
              and max(a["step_gaps"]) <= SERVE_SHARDED_REL,
              f"sharded serving {arch}: rank {r}'s logits are off the single rank's")
        check(a["fault_gap"] >= SERVE_SHARDED_FAULT_X * SERVE_SHARDED_REL,
              f"sharded serving {arch}: the planted fault reads under "
              f"{SERVE_SHARDED_FAULT_X} times the limit")
        check(max(a["f32_gaps"]) <= SERVE_F32_REL,
              f"sharded serving {arch}: rank {r}'s f32 logits are off the single rank's")
        check(a["f32_fault_gap"] >= SERVE_SHARDED_FAULT_X * SERVE_F32_REL,
              f"sharded serving {arch}: the small planted fault reads under "
              f"{SERVE_SHARDED_FAULT_X} times the f32 limit")
        check(a["greedy_is_argmax"] and a["token_misses"] == 0 and a["tokens_checked"] > 0,
              f"sharded serving {arch}: rank {r}'s greedy tokens are off")
        check(a["retry_bitwise"] and a["prefill_bitwise"] and a["replicas_agree"],
              f"sharded serving {arch}: a retry, a repeat or a replica differs")
        check(a["peak_gb"] * 1e9 <= need,
              f"sharded serving {arch}: rank {r}'s peak is past the dry run's bytes")
    return {"single": one, "ranks": ranks,
            "c10d_model": {k: sum(v.values()) for k, v in models.items()},
            "need": need, "layers": cfg.n_layers}


# ------------- MLA's query heads over a model axis they do not divide -------------

# minicpm3-4b at full width and UNEVEN_LAYERS layers on (data 1, model 3):
# three gloo ranks sharing the card, one spawn for training and serving.
# On this mesh the rules cut q_up alone (3840 columns, 1280 a rank: 13 1/3
# heads, so it is gathered over "model"); kv_up's 5120 columns, o's 2560
# rows, the FFN's 6400 and the 73 472-row vocabulary do not divide by 3 and
# stay whole. The ranks run 13, 13 and 14 of the 40 heads.
UNEVEN_SHAPE, UNEVEN_LAYERS = (1, 3), 2
# The serving prompts: their caches hold UNEVEN_PROMPT + SERVE_SHARDED_STEPS
# = 270 slots, which divide by 3, so the latent is cut by slots (90 a rank)
# and each decode step gathers q_c and q_rope in blocks of 13, 13 and 14
# heads, padded to 14. The prompt fills ranks 0 and 1 and 74 of rank 2's
# slots; the decode writes rank 2's.
UNEVEN_PROMPT = 254
UNEVEN_SERVE = ("TP_ONLY_RULES", UNEVEN_LAYERS, UNEVEN_PROMPT)


def _uneven_rank(rank: int, world: int, kw: dict) -> dict:
    """One rank of the uneven-heads phase: the sharded training job
    (``_sharded_job``), then sharded serving (``_serve_arch_on_rank`` with
    ``UNEVEN_SERVE``), each with ``plant_o_rows`` as its planted fault."""
    import gc

    import torch

    from repro_torch import reduce as R
    from repro_torch.launch import mesh as mesh_lib

    R.set_default_backend("cuda_fused")
    mesh_lib.init_process_group(kw.get("device", "cuda"))
    try:
        train = _sharded_job(rank, world, kw["train"])
        gc.collect()
        torch.cuda.empty_cache()
        mesh = mesh_lib.make_mesh(UNEVEN_SHAPE, SHARDED_AXES)
        serve = _serve_arch_on_rank(rank, world, mesh, MINICPM, kw["serve_path"], UNEVEN_SERVE,
                                    o_rows=True)
        return {"train": train, "serve": serve, "transport": mesh.backend,
                "device": str(mesh.device), "peak_gb": max(train["peak_gb"], serve["peak_gb"])}
    finally:
        mesh_lib.shutdown(barrier=False)


def run_uneven_heads_phase() -> dict:
    """MLA's 40 query heads over a model axis of 3 (``models.parallel``'s
    module doc): three gloo ranks sharing the first card run minicpm3-4b at
    full width and ``UNEVEN_LAYERS`` layers on (data 1, model 3), in one
    spawn. Training (DEFAULT_RULES, ``SHARDED_STEPS`` steps of 4 x 512) is
    held to the single-rank step as ``run_sharded_phase`` holds its archs
    (``_check_sharded_arch``: loss, grad norm and clip within
    ``SHARDED_LOSS_REL`` / ``SHARDED_GRAD_REL``, step 1's update and
    gradient of layer 0's leaves, replicas' bits, c10d bytes equal to the
    dry run's (1, 3) cell, launches a rank equal to the launch model: K7
    over the whole vocabulary), with ``plant_o_rows`` as its planted fault
    (``SHARDED_FAULT_X`` times ``SHARDED_LEAF_GRAD_REL``). Serving
    (TP_ONLY_RULES, ``SLOTS`` prompts of ``UNEVEN_PROMPT`` tokens,
    ``SERVE_SHARDED_STEPS`` teacher-forced decode steps, the latent cut by
    slots) is held as ``run_sharded_serving_phase`` holds its archs
    (``_check_serving_arch``), its planted faults at bf16 and at f32
    ``plant_o_rows``. Returns rank 0's
    launches of the training step and of the serving calls."""
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.parallel import Plan

    t_phase = time.time()
    cfg = dataclasses.replace(get_arch(MINICPM), n_layers=UNEVEN_LAYERS)
    mesh = abstract_mesh(UNEVEN_SHAPE, SHARDED_AXES)
    plan = Plan(cfg, mesh, sharded_specs(cfg, SHARDED_RULES[MINICPM], mesh))
    modes = plan.layout(plan.specs["layers"][0], "attn")["mla"]
    blocks = plan._blocks(cfg.n_heads)
    print(f"uneven heads: {MINICPM}'s {cfg.n_heads} heads over {UNEVEN_SHAPE[1]} model ranks: "
          f"{blocks}; head leaves {modes}")
    check(modes == {"q_up": "gather", "kv_up": "whole", "o": "whole"}
          and [b - a for a, b in blocks] == [13, 13, 14],
          "uneven heads: the layout is not the one this phase runs")
    job = {"arch": MINICPM, "layers": UNEVEN_LAYERS, "shape": UNEVEN_SHAPE,
           "rules": SHARDED_RULES[MINICPM], "fault": "o_rows"}
    world = math.prod(UNEVEN_SHAPE)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        job["probe"] = os.path.join(tmp, "train_single.pt")
        serve_path = os.path.join(tmp, "serve_single.pt")
        t0 = time.time()
        single_train = _sharded_single(MINICPM, UNEVEN_LAYERS, job["probe"])
        single_serve = serving_single(MINICPM, serve_path, UNEVEN_SERVE)
        print(f"uneven heads: the single rank's steps and serving {time.time() - t0:.1f} s")
        ranks = spawn_ranks("uneven", world, train=job, serve_path=serve_path, one_card=True)
    for r, res in enumerate(ranks):
        check(res["transport"] == "gloo" and res["device"] == "cuda:0",
              f"uneven heads: rank {r} did not share card 0 over gloo")
    train = _check_sharded_arch(MINICPM, UNEVEN_LAYERS, UNEVEN_SHAPE,
                                [r["train"] for r in ranks], single_train, planted="o_rows")
    serve = _check_serving_arch(MINICPM, UNEVEN_SERVE, UNEVEN_SHAPE,
                                [r["serve"] for r in ranks], single_serve,
                                ranks[0]["transport"])
    torch.cuda.empty_cache()
    r0 = ranks[0]["serve"]
    out = {"train": train, "serve": serve, "train_launches": ranks[0]["train"]["launches"],
           "serve_launches": {k: sum(r0[f"{m}_launches"].get(k, 0)
                                     for m in ("prefill", "decode", "greedy"))
                              for k in r0["prefill_launches"]},
           "ranks": ranks, "single_train": single_train, "wall_s": time.time() - t_phase}
    print(f"uneven heads phase: {out['wall_s']:.1f} s")
    return out


def run_meter_phase() -> dict:
    """The launch meter on the card at 2^28 f32 and bf16: the bytes the
    wrappers note (``measured_hbm_bytes``) equal ``ReducePlan.hbm_bytes(...)
    .launch_io`` for ``reduce`` on cuda_hier (every level) and on
    cuda_fused's one-lane in-launch finish; at the device's lanes
    cuda_fused's read side equals the plan model's and the whole launch
    equals ``cost_model.fused_launch_bytes`` (the port's kernel folds its
    lanes in the launch, where the reference's model charges (C, m, m)
    partials). ``assert_staging_free`` on the kernel routes of ``reduce``,
    ``reduce_many`` over 100 arrays and ``reduce_tree`` over the same."""
    import torch

    from repro_torch import reduce as R
    from repro_torch.core import cost_model
    from repro_torch.kernels.mma_reduce import default_num_lanes

    gen = torch.Generator(device=DEVICE).manual_seed(12)
    out = {}
    x32 = torch.randn((PAPER_N,), generator=gen, device=DEVICE)
    for x in (x32, x32.to(torch.bfloat16)):
        name = str(x.dtype)[6:]
        n = x.numel()
        hier = R.plan_for(x.shape, x.dtype, backend="cuda_hier")
        one = R.plan_for(x.shape, x.dtype, backend="cuda_fused", num_lanes=1)
        lanes = default_num_lanes(x)
        many = R.plan_for(x.shape, x.dtype, backend="cuda_fused", num_lanes=lanes)
        got = {
            "cuda_hier": (R.measured_hbm_bytes(R.reduce, x, plan=hier),
                          hier.hbm_bytes(n, x.dtype).launch_io),
            "cuda_fused one lane, sqrt in the launch": (
                R.measured_hbm_bytes(R.reduce, x, plan=one, epilogue="sqrt"),
                one.hbm_bytes(n, x.dtype, epilogue=1).launch_io),
        }
        for what, (meas, model) in got.items():
            print(f"meter {what} at 2^28 {name}: measured {meas} bytes, plan model {model} "
                  f"(must be equal)")
            check(meas == model, f"meter: {what} at {name}: {meas} != {model}")
        _, records = R.launch_records(R.reduce, x, plan=many)
        port = cost_model.fused_launch_bytes(n, x.element_size(), num_lanes=lanes)
        ref = many.hbm_bytes(n, x.dtype)
        print(f"meter cuda_fused at {lanes} lanes, 2^28 {name}: read {records[0].read_bytes} "
              f"(plan model {ref.kernel_read} + the lanes' words read back), written "
              f"{records[0].write_bytes} (fused_launch_bytes {port.kernel_write}; the "
              f"reference's model charges {ref.kernel_write} of (C, m, m) partials)")
        check(len(records) == 1 and records[0].route == "kernel"
              and records[0].read_bytes == port.kernel_read
              and records[0].write_bytes == port.kernel_write
              and port.kernel_read - (port.kernel_write - 4) == ref.kernel_read,
              f"meter: cuda_fused at {lanes} lanes, {name}")
        for backend in ("cuda_fused", "cuda_hier"):
            R.assert_staging_free(R.reduce, x, backend=backend)
        out[name] = {k: v[0] for k, v in got.items()}
    sizes = torch.randint(2**16, 2**20, (100,), generator=gen, device=DEVICE).tolist()
    arrays = [torch.randn((s,), generator=gen, device=DEVICE) for s in sizes]
    floor = min(a.numel() for a in arrays)
    R.assert_staging_free(R.reduce_many, arrays, backend="cuda_fused", min_elems=floor)
    R.assert_staging_free(R.reduce_tree, arrays, kind="norm2", backend="cuda_fused",
                          min_elems=floor)
    total = sum(a.numel() for a in arrays)
    parts = R.plan_for((total,), torch.float32, backend="cuda_fused")
    meas = R.measured_hbm_bytes(R.reduce_many, arrays, plan=parts)
    model = parts.hbm_bytes(total, torch.float32, segments=len(arrays)).launch_io
    print(f"meter reduce_many over {len(arrays)} arrays ({total} f32): measured {meas}, plan "
          f"model {model}; staging-free: reduce, reduce_many, reduce_tree on the kernel routes")
    check(meas == model, "meter: reduce_many's parts launch")
    return out


def run_autotune_phase() -> dict:
    """``autotune((2**28,), f32)`` and bf16 on the card over every backend
    (cuda_fused sweeping tiles_per_block 2, 4, 8, 16 x 1, 2, 4 CTAs per SM;
    cuda_hier the tiles): the winner and its time beside the untuned auto
    plan's, timed the same way (CUDA events, best of 3 after a warm call);
    then ``plan_for`` on auto returns the winner from the memo (its hits
    rise). The tuned table is cleared after, so the later phases keep the
    untuned route."""
    import torch

    from repro_torch import reduce as R
    from repro_torch.reduce.plan import _elapsed_s

    out = {}
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        x = torch.randn((PAPER_N,), generator=gen, device=DEVICE).to(dtype)
        R.plan_cache_clear(clear_tuned=True)
        auto = R.plan_for(x.shape, dtype, device=x.device)
        with torch.no_grad():
            auto_s = _elapsed_s(lambda: R.reduce(x, plan=auto), x.device, 3)
        del x
        timings = {}
        t0 = time.perf_counter()
        best = R.autotune((PAPER_N,), dtype, timings=timings)
        wall = time.perf_counter() - t0
        before = R.plan_cache_info()
        first = R.plan_for((PAPER_N,), dtype, device=DEVICE)
        again = R.plan_for((PAPER_N,), dtype, device=DEVICE)
        after = R.plan_cache_info()
        print(f"autotune 2^28 {name}: {len(timings)} candidates in {wall:.1f} s; winner "
              f"{best.backend} tiles_per_block {best.tiles_per_block} lanes {best.num_lanes}: "
              f"{timings[best] * 1e3:.4f} ms; untuned auto plan {auto.backend} (tiles "
              f"{auto.tiles_per_block}, lanes {auto.num_lanes}): {auto_s * 1e3:.4f} ms; "
              f"plan_for hits {after.hits - before.hits}, misses {after.misses - before.misses}")
        for plan, secs in sorted(timings.items(), key=lambda kv: kv[1])[:5]:
            print(f"    {secs * 1e3:9.4f} ms  {plan.backend} tiles {plan.tiles_per_block} "
                  f"lanes {plan.num_lanes}")
        check((first.backend, first.tiles_per_block, first.num_lanes)
              == (best.backend, best.tiles_per_block, best.num_lanes) and again is first
              and after.hits - before.hits == 1, f"autotune {name}: plan_for did not return the "
              "winner from the memo")
        out[name] = {"winner": [best.backend, best.tiles_per_block, best.num_lanes],
                     "winner_ms": timings[best] * 1e3, "auto_ms": auto_s * 1e3,
                     "candidates": len(timings)}
    R.plan_cache_clear(clear_tuned=True)
    return out


def mark(t_start: float, what: str) -> None:
    """One line of the script's timeline: seconds since ``t_start``."""
    print(f"[chip_smoke +{time.time() - t_start:.1f} s] {what} done", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository (src/repro_torch is missing)",
              file=sys.stderr)
        return 2
    t_start = time.time()
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    build.library()
    print(f"kernel build: {time.time() - t0:.1f} s (nvcc, {len(build.SOURCES)} sources in parallel)")

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    results: dict = {}
    check_norms(results, gen)
    check_attention(results, gen)
    check_parts(results, gen)
    check_cross_entropy(results, gen)
    check_fused_sum(results, gen)
    check_tile_partials(results, gen)
    check_moments_and_kahan(results, gen)
    check_matmul_stats(results, gen)
    mark(t_start, "kernel checks")
    ms_launches = run_matmul_stats_path()
    torch.cuda.empty_cache()
    check_reduce_against_cpu(gen)
    check_auto_route(gen)
    mark(t_start, "reduce card vs CPU")
    torch.cuda.empty_cache()
    check_dense_shapes(results)
    torch.cuda.empty_cache()
    check_moe_shapes(results)
    torch.cuda.empty_cache()
    check_mla_ssm_shapes(results)
    torch.cuda.empty_cache()
    check_rg_vision_shapes(results)
    torch.cuda.empty_cache()
    check_audio_shapes(results)
    torch.cuda.empty_cache()
    check_llama_110m_shapes(results)
    mark(t_start, "arch shapes")
    torch.cuda.empty_cache()
    meter = run_meter_phase()
    torch.cuda.empty_cache()
    tuned = run_autotune_phase()
    mark(t_start, "meter, autotune")
    torch.cuda.empty_cache()
    check_backward_times(results, gen)
    for arch in DENSE_ARCHS + MOE_ARCHS + NEW_ARCHS + RG_VISION_ARCHS + (MUSICGEN,):
        check_tiny_against_cpu(arch)
    check_full_width_against_cpu()
    mark(t_start, "tiny and 2-layer models card vs CPU")
    serve_launches, serving = {}, {}
    for arch in DENSE_ARCHS:  # the olmo and internlm2 engines are freed before deepseek's
        serve_launches[arch], serving[arch] = serve_full_width(arch)
    serve_launches[GRANITE], serving[GRANITE] = serve_full_width(GRANITE)
    check_dbrx_refused()
    serve_launches[DBRX], serving[DBRX] = serve_full_width(DBRX, n_layers=DBRX_LAYERS)
    torch.cuda.empty_cache()
    for arch in NEW_ARCHS:
        serve_launches[arch], serving[arch] = serve_full_width(arch)
    torch.cuda.empty_cache()
    serve_launches[RG], serving[RG] = serve_full_width(
        RG, after=lambda eng: check_ring_case(eng, DECODE_LOGIT_TOL, plant=False))
    serving[RG].update(check_at_f32(RG, check_ring_case))
    serve_launches[VISION], serving[VISION] = serve_full_width(
        VISION, after=lambda eng: check_vision_gated(eng, DECODE_LOGIT_TOL, plant=False))
    serving[VISION].update(check_at_f32(VISION, check_vision_gated))
    ring_launches = serving[RG].pop("bfloat16_ring_launches")
    serving[RG].pop("float32_ring_launches")
    torch.cuda.empty_cache()
    serve_launches[MUSICGEN], serving[MUSICGEN] = serve_full_width(MUSICGEN)
    mark(t_start, "full-width serving")
    torch.cuda.empty_cache()
    nonkernel = run_nonkernel_route()
    torch.cuda.empty_cache()

    from repro_torch import reduce as R

    R.set_default_backend("cuda_fused")  # the training CLI's --reduce-backend cuda_fused
    try:
        for arch in DENSE_ARCHS + MOE_ARCHS + NEW_ARCHS + RG_VISION_ARCHS + (MUSICGEN,):
            check_tiny_training_against_cpu(arch)
        check_full_width_training_against_cpu()
        check_parts_training(results, gen)
        train_launches, train_prof = train_full_width()
        mark(t_start, "training checks, olmo-1b training")
        torch.cuda.empty_cache()
        examples = run_examples_phase()
        mark(t_start, "examples")
        torch.cuda.empty_cache()
        guarded = run_guarded_training(train_prof["busy_ms"])
        drill = run_rollback_drill()
        mark(t_start, "guarded training, rollback drill")
        torch.cuda.empty_cache()
        mesh = run_data_mesh_phase()
        mark(t_start, "data mesh")
        torch.cuda.empty_cache()
        sharded = run_sharded_phase(results, gen)
        mark(t_start, "sharded step")
        torch.cuda.empty_cache()
        serving_sharded = run_sharded_serving_phase()
        mark(t_start, "sharded serving")
        torch.cuda.empty_cache()
        uneven = run_uneven_heads_phase()
        mark(t_start, "uneven heads")
        torch.cuda.empty_cache()
        intern_launches, intern_prof = train_full_width("internlm2-1.8b", guarded_steps=1)
        clip_stat = profile_clip_statistic("internlm2-1.8b",
                                           results["mma_sum_parts"]["census_on_ms"])
        torch.cuda.empty_cache()
        granite_launches, granite_prof = train_full_width(GRANITE, guarded_steps=1)
        granite_clip = profile_clip_statistic(GRANITE, results["mma_sum_parts"]["census_on_ms"])
        torch.cuda.empty_cache()
        mamba_launches, mamba_prof = train_full_width(MAMBA, guarded_steps=1)
        mamba_clip = profile_clip_statistic(MAMBA, results["mma_sum_parts"]["census_on_ms"])
        torch.cuda.empty_cache()
        check_full_depth_refused(MINICPM)
        minicpm_launches, minicpm_prof = train_full_width(MINICPM, guarded_steps=1,
                                                          n_layers=MINICPM_TRAIN_LAYERS)
        minicpm_clip = profile_clip_statistic(MINICPM, results["mma_sum_parts"]["census_on_ms"],
                                              n_layers=MINICPM_TRAIN_LAYERS)
        cut_training = {}
        for arch, layers in ((RG, RG_TRAIN_LAYERS), (VISION, VISION_TRAIN_LAYERS)):
            torch.cuda.empty_cache()
            check_full_depth_refused(arch)
            launches, prof = train_full_width(arch, guarded_steps=1, n_layers=layers)
            clip = profile_clip_statistic(arch, results["mma_sum_parts"]["census_on_ms"],
                                          n_layers=layers)
            cut_training[arch] = (layers, launches, prof, clip)
        torch.cuda.empty_cache()
        musicgen_launches, musicgen_prof = train_full_width(MUSICGEN, guarded_steps=1)
        musicgen_clip = profile_clip_statistic(MUSICGEN, results["mma_sum_parts"]["census_on_ms"])
        torch.cuda.empty_cache()
        fit = run_fit_phase()
        mark(t_start, "full-width training, fit")
    finally:
        R.set_default_backend(None)
    torch.cuda.empty_cache()
    check_segments(results, gen)
    torch.cuda.empty_cache()
    check_scan(results, gen)
    torch.cuda.empty_cache()
    check_parts_bf16(results, gen)
    check_multi_against_cpu(gen)
    check_packing_offsets(gen)
    torch.cuda.empty_cache()
    multi_launches = run_multi_reduce_path()
    mark(t_start, "multi-reduce and scan")
    torch.cuda.empty_cache()
    paper_launches = run_reduce_demo()
    mark(t_start, "reduce demo")

    kernels = []
    results["mma_sum_segments"]["internlm2_clip_statistic"] = clip_stat
    results["mma_sum_segments"]["granite_clip_statistic"] = granite_clip
    results["mma_sum_segments"]["mamba2_clip_statistic"] = mamba_clip
    results["mma_sum_segments"]["minicpm3_16_layers_clip_statistic"] = minicpm_clip
    results["mma_sum_segments"]["musicgen_clip_statistic"] = musicgen_clip
    olmo_serve = serve_launches["olmo-1b"]
    for name in KERNELS:
        r = results[name]
        main_path = (paper_launches if name in PAPER_KERNELS else
                     multi_launches if name in MULTI_KERNELS else
                     ms_launches if name == "matmul_stats" else
                     sharded["launches"] if name == "cross_entropy_partial" else
                     intern_launches if name == "rmsnorm" else train_launches)
        check(main_path[name] > 0, f"{name} was not launched on its main path")
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": main_path[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "timed_by": {k: timed_by(r[k]) for k in ("ms", "plain_ms", "library_ms")
                         if r[k] is not None},
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "call_ms": r["call_ms"],
            "launches_training": train_launches[name],
            "launches_serving": olmo_serve[name], "launches_paper": paper_launches[name],
            "launches_serving_internlm2": serve_launches["internlm2-1.8b"][name],
            "launches_serving_deepseek": serve_launches["deepseek-7b"][name],
            "launches_training_internlm2": intern_launches[name],
            "launches_guarded_training_internlm2": intern_launches["guarded"][name],
            "launches_serving_granite": serve_launches[GRANITE][name],
            "launches_serving_dbrx_2_layers": serve_launches[DBRX][name],
            "launches_training_granite": granite_launches[name],
            "launches_guarded_training_granite": granite_launches["guarded"][name],
            "launches_serving_minicpm3": serve_launches[MINICPM][name],
            "launches_serving_mamba2": serve_launches[MAMBA][name],
            "launches_training_mamba2": mamba_launches[name],
            "launches_guarded_training_mamba2": mamba_launches["guarded"][name],
            "launches_training_minicpm3_16_layers": minicpm_launches[name],
            "launches_guarded_training_minicpm3_16_layers": minicpm_launches["guarded"][name],
            "launches_serving_recurrentgemma": serve_launches[RG][name],
            "launches_serving_recurrentgemma_ring_case": ring_launches[name],
            "launches_serving_llama_vision": serve_launches[VISION][name],
            f"launches_training_recurrentgemma_{RG_TRAIN_LAYERS}_layers":
                cut_training[RG][1][name],
            f"launches_guarded_training_recurrentgemma_{RG_TRAIN_LAYERS}_layers":
                cut_training[RG][1]["guarded"][name],
            f"launches_training_llama_vision_{VISION_TRAIN_LAYERS}_layers":
                cut_training[VISION][1][name],
            f"launches_guarded_training_llama_vision_{VISION_TRAIN_LAYERS}_layers":
                cut_training[VISION][1]["guarded"][name],
            "launches_serving_musicgen": serve_launches[MUSICGEN][name],
            "launches_training_musicgen": musicgen_launches[name],
            "launches_guarded_training_musicgen": musicgen_launches["guarded"][name],
            "launches_multi_reduce": multi_launches[name],
            "launches_matmul_stats": ms_launches[name],
            "launches_guarded_training": guarded["launches"][name],
            "launches_rollback_drill": drill["launches"][name],
            "launches_data_mesh": mesh["launches"].get(name, 0),
            f"launches_sharded_deepseek_{sharded['deepseek-7b']['layers']}_layers_rank0":
                sharded["launches"][name],
            "launches_sharded_granite_rank0": sharded[GRANITE]["ranks"][0]["launches"][name],
            **{f"launches_sharded_{arch}_{sharded[arch]['layers']}_layers_rank0":
               sharded[arch]["ranks"][0]["launches"][name] for arch in SHARDED_MIXERS},
            "launches_sharded_serving_deepseek_rank0":
                serving_sharded["launches"]["deepseek-7b"].get(name, 0),
            "launches_sharded_serving_granite_rank0":
                serving_sharded["launches"][GRANITE].get(name, 0),
            **{f"launches_sharded_serving_{arch}_{serving_sharded[arch]['layers']}_layers_rank0":
               serving_sharded["launches"][arch].get(name, 0)
               for arch in SERVE_SHARDED if arch not in ("deepseek-7b", GRANITE)},
            f"launches_uneven_heads_{MINICPM}_{UNEVEN_LAYERS}_layers_training_rank0":
                uneven["train_launches"].get(name, 0),
            f"launches_uneven_heads_{MINICPM}_{UNEVEN_LAYERS}_layers_serving_rank0":
                uneven["serve_launches"].get(name, 0),
            "launches_forward_kernel_route": nonkernel["launches"].get(name, 0),
            "launches_train_100m": examples["train_100m"][name],
            "launches_quickstart": examples["quickstart"][name],
            "launches_serve_batched": examples["serve_batched"][name],
        }
        entry.update({k: v for k, v in r.items() if k not in entry})
        kernels.append(entry)
    for k in kernels:
        lib = "-" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.1f} us"
        shape = ("2^28 f32" if k["name"] in PAPER_KERNELS + MULTI_KERNELS
                 else "(2048x8192)@(8192x2048) bf16" if k["name"] == "matmul_stats"
                 else "deepseek-7b's rank shape on (2, 2), 1024 x 51200 f32"
                 if k["name"] == "cross_entropy_partial"
                 else "the olmo training shape")
        print(f"{k['name']}: device {k['ms'] * 1e3:.2f} us per call at {shape} "
              f"(whole call {k['call_ms'] * 1e3:.1f} us; plain {k['plain_ms'] * 1e3:.1f} us, "
              f"library {lib}, bound {k['bound_ms'] * 1e3:.2f} us by {k['bound_by']}), "
              f"launches: {k['launches_training']} in training, {k['launches_serving']} in "
              f"serving, {k['launches_paper']} in the paper's demo, "
              f"{k['launches_multi_reduce']} in the multi-reduce path, "
              f"{k['launches_matmul_stats']} in the matmul_stats path")
    print(f"backward passes (torch math): {results['backward']}")
    k4 = results["mma_sum_parts"]
    print(f"guarded training: step device busy {guarded['busy_ms']:.3f} ms (plain "
          f"{guarded['plain_busy_ms']:.3f} ms); K4 at the training shape with the census "
          f"{k4['census_on_ms']:.4f} ms, without {k4['census_off_ms']:.4f} ms; non-kernel "
          f"route forward ms {nonkernel['forward_ms']}; checkpoints "
          f"{[(op, int(st), int(b), w) for op, st, b, w in drill['records']]}")
    for arch, f in serving.items():
        print(f"serving {arch}: {f['tokens_per_s']:.1f} tok/s, p50 {f['p50_ms']:.2f} ms, p99 "
              f"{f['p99_ms']:.2f} ms, held {f['held_gb']:.2f} GB; prefill wall "
              f"{f['prefill_wall_ms']:.3f} ms busy {f['prefill_busy_ms']:.3f} ms; decode wall "
              f"{f['decode_wall_ms']:.3f} ms busy {f['decode_busy_ms']:.3f} ms")
    print(f"training internlm2-1.8b: step wall {intern_prof['wall_ms']:.3f} ms, device busy "
          f"{intern_prof['busy_ms']:.3f} ms (olmo-1b {train_prof['wall_ms']:.3f} / "
          f"{train_prof['busy_ms']:.3f} ms); clip statistic {clip_stat}")
    print(f"training {GRANITE}: step wall {granite_prof['wall_ms']:.3f} ms, device busy "
          f"{granite_prof['busy_ms']:.3f} ms, idle share "
          f"{max(0.0, 1.0 - granite_prof['busy_ms'] / granite_prof['wall_ms']):.3f}, peak "
          f"{granite_launches['peak_gb']:.2f} GB, aux {granite_prof['aux']:.6g}; clip statistic "
          f"{granite_clip['statistic_ms']:.3f} ms (K8 {granite_clip['statistic_k8_ms']:.3f}) "
          f"over {granite_clip['n']} values against internlm2's {clip_stat['statistic_ms']:.3f} "
          f"ms over {clip_stat['n']}")
    for arch, launches, prof, clip in ((MAMBA, mamba_launches, mamba_prof, mamba_clip),
                                       (f"{MINICPM} ({MINICPM_TRAIN_LAYERS} layers)",
                                        minicpm_launches, minicpm_prof, minicpm_clip)):
        print(f"training {arch}: step wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['busy_ms']:.3f} ms, idle share "
              f"{max(0.0, 1.0 - prof['busy_ms'] / prof['wall_ms']):.3f}, peak "
              f"{launches['peak_gb']:.2f} GB; clip statistic {clip['statistic_ms']:.3f} ms (K8 "
              f"{clip['statistic_k8_ms']:.3f}) over {clip['n']} values in {clip['segments']} "
              "leaves")
    print(f"training {MUSICGEN}: step wall {musicgen_prof['wall_ms']:.3f} ms, device busy "
          f"{musicgen_prof['busy_ms']:.3f} ms, idle share "
          f"{max(0.0, 1.0 - musicgen_prof['busy_ms'] / musicgen_prof['wall_ms']):.3f}, peak "
          f"{musicgen_launches['peak_gb']:.2f} GB (guarded "
          f"{musicgen_launches['guarded']['peak_gb']:.2f}); clip statistic "
          f"{musicgen_clip['statistic_ms']:.3f} ms (K8 {musicgen_clip['statistic_k8_ms']:.3f}) "
          f"over {musicgen_clip['n']} values in {musicgen_clip['segments']} leaves")
    for arch, (layers, launches, prof, clip) in cut_training.items():
        print(f"training {arch} ({layers} layers): step wall {prof['wall_ms']:.3f} ms, device "
              f"busy {prof['busy_ms']:.3f} ms, idle share "
              f"{max(0.0, 1.0 - prof['busy_ms'] / prof['wall_ms']):.3f}, peak "
              f"{launches['peak_gb']:.2f} GB; clip statistic {clip['statistic_ms']:.3f} ms (one "
              f"K4 launch) over {clip['n']} values in {clip['segments']} leaves")
    wide = results["flash_attention"]["wide"]
    ring = wide["ring_prefill"]
    print(f"K6 wide variant with the window {RG_WINDOW} at {SLOTS} x {RING_PROMPT}: device "
          f"{ring['ms'] * 1e3:.2f} us, call {ring['call_ms'] * 1e3:.2f} us (SDPA with the mask "
          f"{ring['library_ms'] * 1e3:.2f}, bound {ring['bound_ms'] * 1e3:.2f}); decode vs "
          f"forward, bf16 / f32: the ring case {serving[RG]['bfloat16_ring_gap']:.4g} / "
          f"{serving[RG]['float32_ring_gap']:.4g} (fault at f32 "
          f"{serving[RG]['float32_ring_fault_gap']:.4g}), vision gated "
          f"{serving[VISION]['bfloat16_gated_gap']:.4g} / "
          f"{serving[VISION]['float32_gated_gap']:.4g} (fault at f32 "
          f"{serving[VISION]['float32_gated_fault_gap']:.4g})")
    print(f"K6 wide variant at recurrentgemma's heads (16 q / 1 kv x 256): training 4 x 512 "
          f"{wide['training']['ms'] * 1e3:.2f} us (SDPA {wide['training']['library_ms'] * 1e3:.2f}, "
          f"bound {wide['training']['bound_ms'] * 1e3:.2f}), prefill 4 x 256 "
          f"{wide['prefill']['ms'] * 1e3:.2f} us (SDPA {wide['prefill']['library_ms'] * 1e3:.2f}, "
          f"bound {wide['prefill']['bound_ms'] * 1e3:.2f})")
    print(f"fit check, {RG}: {fit}")
    print(f"train_100m (llama-110m, {LLAMA_STEPS} x {LLAMA_BATCH} x {LLAMA_SEQ}): "
          f"{examples['params']} parameters, loss {examples['losses'][0]:.4f} -> "
          f"{examples['losses'][-1]:.4f}, step wall p50 {examples['p50_ms']:.3f} ms "
          f"({examples['steps_per_s']:.3f} steps/s), peak {examples['peak_gb']:.3f} GB, "
          f"{examples['wall_s']:.1f} s; launches a step "
          f"{ {k: v / LLAMA_STEPS for k, v in examples['train_100m'].items() if v} }")
    print(f"data mesh: engine {mesh['engine']}; training step peaks {mesh['peak_gb']} GB a "
          f"rank")
    for arch in SHARDED_ARCHS:
        sh = sharded[arch]
        print(f"sharded {arch} ({sh['layers']} layers, (data {sh['shape'][0]}, model "
              f"{sh['shape'][1]}), 4 gloo ranks on one card): step walls rank 0 "
              f"{[round(w, 1) for w in sh['ranks'][0]['wall_ms']]} ms (single rank "
              f"{sh['single']['wall_ms']:.1f} ms), c10d bytes in a rank a step "
              f"{sh['model']['total_bytes']}, peaks {[round(r['peak_gb'], 2) for r in sh['ranks']]}"
              f" GB, step 1's gradient gap {sh['grad_gap']:.4g}"
              + (f" (planted fault {sh['fault_gap']:.4g})" if "fault_gap" in sh else ""))
    for arch in ("deepseek-7b", GRANITE):
        sv = serving_sharded[arch]
        r0 = sv["ranks"][0]
        print(f"sharded serving {arch} (4 gloo ranks on one card): rank 0 prefill "
              f"{r0['prefill_ms']:.1f} ms (single rank {sv['single']['prefill_ms']:.1f}), decode "
              f"{r0['decode_ms']:.2f} ms a token (single rank {sv['single']['decode_ms']:.2f}); "
              f"c10d bytes in a rank {sv['c10d_model']}; peaks "
              f"{[round(r['peak_gb'], 3) for r in sv['ranks']]} GB (dry run "
              f"{sv['need'] / 1e9:.3f})")
    ut, us = uneven["train"], uneven["serve"]
    print(f"uneven heads, {MINICPM} ({UNEVEN_LAYERS} layers, (data 1, model 3), 3 gloo ranks on "
          f"one card): step walls rank 0 "
          f"{[round(w, 1) for w in uneven['ranks'][0]['train']['wall_ms']]} ms (single rank "
          f"{uneven['single_train']['wall_ms']:.1f} ms), c10d bytes a step "
          f"{ut['model']['total_bytes']}, step 1's gradient gap {ut['grad_gap']:.4g} (planted "
          f"fault {ut['fault_gap']:.4g}); serving rank 0 prefill "
          f"{us['ranks'][0]['prefill_ms']:.1f} ms (single {us['single']['prefill_ms']:.1f}), "
          f"decode {us['ranks'][0]['decode_ms']:.2f} ms a token (single "
          f"{us['single']['decode_ms']:.2f}), c10d {us['c10d_model']}; phase "
          f"{uneven['wall_s']:.1f} s")
    print(f"dry run, deepseek-7b train_4k (a model figure): (2, 2) {sharded['dryrun_2x2']}, "
          f"(16, 16) {sharded['dryrun_single']} bytes a rank")
    print(f"meter: {meter}; autotune: {tuned}")
    print(f"chip_smoke wall time: {time.time() - t_start:.1f} s (the build included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

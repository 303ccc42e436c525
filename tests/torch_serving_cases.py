"""The sharded serving cases and their one spawn, shared by
``tests/test_torch_sharded_serving.py`` and ``tests/test_torch_dryrun.py``.

Tiny cases on one (data 2, model 2) spawn of gloo CPU ranks, each at f32
on the non-kernel route with the attention's bf16 operand rounding off
(``torch_mesh_workers.exact_f32_attention``, MLA's too), weights from the
JAX package's ``init_params`` (numpy, carried across by
``models.convert.params_from_jax``):

  deepseek       deepseek-7b, TP_ONLY_RULES: heads and kv heads cut, the
                 vocab-parallel head; caches cut by heads
  olmo           olmo-1b, SMALL_MODEL_RULES, one prompt: weights whole over
                 "model" (FSDP over "data"), caches cut by heads, the head
                 outputs gathered before the whole o; the one row held
                 whole on both data ranks
  granite        granite-moe-1b-a400m, SMALL_MODEL_RULES: EP in the prefill
                 and the decode
  internlm2      internlm2-1.8b with one kv head, TP_ONLY_RULES: k and v
                 gathered over "model", caches cut by sequence, the
                 split-KV merge
  big            deepseek-7b, BIG_MODEL_RULES: FSDP gathers in serving
  minicpm3       minicpm3-4b, TP_ONLY_RULES: MLA's heads cut, the latent
                 cut by slots (the prompt in rank 0's, the decode's in rank
                 1's), q_c and q_rope gathered, the latent partials merged
  minicpm3_small minicpm3-4b, SMALL_MODEL_RULES: whole weights, the latent
                 cut by slots
  mamba2         mamba2-780m, SMALL_MODEL_RULES: the state cut by heads
                 (4 of 8 a rank), the conv cache by channels (80 of 160,
                 against x heads of 64 channels: the block ends inside
                 rank 1's heads), the heads' y gathered
  mamba2_tp      mamba2-780m, TP_ONLY_RULES: ``inner_tp``, the gated
                 norm's statistic summed over "model"
  rg             recurrentgemma-9b, TP_ONLY_RULES, prompts of 28 past the
                 window of 16: the RG-LRU's channels, the local attention's
                 one-kv-head ring of 16 slots cut by slots, wrapped over
                 the cut in the prefill
  vision         llama-3.2-vision-11b, TP_ONLY_RULES, a seeded context and
                 the gates open: the cross-attention cache cut by kv heads
  vision_seq     the same with one kv head: the cross-attention cache cut
                 by image tokens, the split-KV merge over them
  musicgen       musicgen-medium, SMALL_MODEL_RULES, a vocabulary of 200 (so
                 that both model ranks hold real columns, rank 1 from
                 column 128 of the head and from row 100 of the table):
                 (B, S, 4) codebook tokens, the vocab-parallel lookup, the
                 K heads' columns gathered, one greedy merge a stream

and the planted faults (``torch_mesh_workers.sharded_serve``), each on
global rank 1:

  fault          internlm2's case, the split-KV merge 2^-10 too large
  fault_ring     rg's case, the ring written at global slot numbers
                 (``fill_kv_cache``'s ``slot0`` taken as 0)
  fault_mla      minicpm3's case, the latent merge's denominators 2^-10 off
  fault_ssm      mamba2's case, the decode's conv block read one channel off
  fault_rec      rg's case, the decode's ``h`` its neighbour's channels
  fault_books    musicgen's case, stream 0's greedy merge on the rank-local
                 column index (no ``vocab0``)

``serving_ranks`` runs the spawn once a test session: under xdist the
first worker to ask runs it and saves what the ranks returned beside the
workers' temporary directories, the others wait on a file lock and load
it.
"""

from __future__ import annotations

import dataclasses
import fcntl

import jax
import numpy as np
import torch

from repro.configs import get_arch as ref_arch
from repro.models import init_params as ref_init

import torch_mesh_workers as W

PROMPT, S_MAX, STEPS, ROWS = 8, 16, 4, 4
RING_PROMPT, RING_S_MAX = 28, 32  # past tiny recurrentgemma's window of 16
GATE = 0.5  # the cross-attention gates, opened (0 at init: the block adds nothing)
RULES = {"deepseek": ("deepseek-7b", "TP_ONLY_RULES", {}, ROWS),
         "olmo": ("olmo-1b", "SMALL_MODEL_RULES", {}, 1),
         "granite": ("granite-moe-1b-a400m", "SMALL_MODEL_RULES", {}, ROWS),
         "internlm2": ("internlm2-1.8b", "TP_ONLY_RULES", {"n_kv_heads": 1}, ROWS),
         "big": ("deepseek-7b", "BIG_MODEL_RULES", {}, ROWS),
         "minicpm3": ("minicpm3-4b", "TP_ONLY_RULES", {}, ROWS),
         "minicpm3_small": ("minicpm3-4b", "SMALL_MODEL_RULES", {}, ROWS),
         "mamba2": ("mamba2-780m", "SMALL_MODEL_RULES", {}, ROWS),
         "mamba2_tp": ("mamba2-780m", "TP_ONLY_RULES", {}, ROWS),
         "rg": ("recurrentgemma-9b", "TP_ONLY_RULES", {}, ROWS),
         "vision": ("llama-3.2-vision-11b", "TP_ONLY_RULES", {}, ROWS),
         "vision_seq": ("llama-3.2-vision-11b", "TP_ONLY_RULES", {"n_kv_heads": 1}, ROWS),
         "musicgen": ("musicgen-medium", "SMALL_MODEL_RULES", {"vocab_size": 200}, ROWS)}
CASES = tuple(RULES)
# the planted faults: (the case they run on, the fault)
FAULTS = {"fault": ("internlm2", True), "fault_ring": ("rg", "ring"),
          "fault_mla": ("minicpm3", "mla"), "fault_ssm": ("mamba2", "ssm"),
          "fault_rec": ("rg", "rec"), "fault_books": ("musicgen", "books")}
VOCAB_WITH_PAD = 250  # the planted greedy rows: 6 pad columns on the last model rank


def ref_cfg(arch: str, over: dict, dtype: str = "float32"):
    return dataclasses.replace(ref_arch(arch, tiny=True), dtype=dtype, **over)


def ref_params(arch: str, over: dict, dtype: str = "float32"):
    cfg = ref_cfg(arch, over, dtype)
    return jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(3), cfg)[0])


def _open_gates(tree: dict) -> dict:
    """The JAX package's parameters with every cross-attention gate (a
    mixer's ``gate``) at ``GATE``."""
    for group in ("units", "tail"):
        for block in tree.get(group, {}).values():
            if "gate" in block["mix"]:
                block["mix"]["gate"] = np.full_like(block["mix"]["gate"], GATE)
    return tree


def case(name: str, **kw) -> dict:
    arch, rules, over, rows = RULES[name]
    prompt, s_max = (RING_PROMPT, RING_S_MAX) if name == "rg" else (PROMPT, S_MAX)
    rcfg = ref_cfg(arch, over)
    vocab, books = min(256, rcfg.vocab_size), (rcfg.n_codebooks,) if rcfg.n_codebooks else ()
    rng = np.random.default_rng(5)
    out = dict(arch=arch, rules=rules, cfg=over, params=ref_params(arch, over),
               prompts=rng.integers(0, vocab, (rows, prompt) + books).astype(np.int64),
               decode=[rng.integers(0, vocab, (rows, 1) + books).astype(np.int64)
                       for _ in range(STEPS)],
               s_max=s_max, runs=2, meter=True)
    if rcfg.n_img_tokens:
        out["ctx"] = rng.standard_normal((rows, rcfg.n_img_tokens, rcfg.d_model)).astype(
            np.float32)
        out["params"] = _open_gates(out["params"])
    return dict(out, **kw)


def planted_rows() -> np.ndarray:
    """(5, 1, 256) f32 rows over the padded vocabulary of ``VOCAB_WITH_PAD``
    tokens, cut at column 128 between the two model ranks: a tie across the
    cut (columns 10 and 200), a tie inside a rank (130 and 140), NaN in
    rank 1 only (150 and 220), NaN in both ranks (5 and 130), and the
    largest value and a NaN in pad columns (253, 254), which the merge must
    not see."""
    rows = np.random.default_rng(0).standard_normal((5, 1, 256)).astype(np.float32)
    rows[0, 0, [10, 200]] = 9.0
    rows[1, 0, [130, 140]] = 9.0
    rows[2, 0, [150, 220]] = np.nan
    rows[3, 0, [5, 130]] = np.nan
    rows[4, 0, 253], rows[4, 0, 254] = 1e9, np.nan
    return rows


def all_cases() -> dict:
    cases = {name: case(name) for name in CASES}
    for name, (on, fault) in FAULTS.items():
        cases[name] = case(on, fault=fault, runs=1, meter=False)
    return cases


def extra() -> dict:
    rng = np.random.default_rng(1)
    return {"greedy": dict(arch="deepseek-7b", cfg={"vocab_size": VOCAB_WITH_PAD},
                           rows=planted_rows()),
            "build": dict(arch="deepseek-7b", params=ref_params("deepseek-7b", {}),
                          tokens=rng.integers(0, 256, (8, 33)).astype(np.int64))}


def _spawn(tmp) -> list:
    return W.run_mesh("serving_cases", (2, 2), ("data", "model"), tmp, all_cases(), extra())


def serving_ranks(request, tmp_path_factory) -> list:
    """What every rank of the one serving spawn returned, in rank order."""
    if getattr(request.config, "workerinput", None) is None:  # no xdist
        return _spawn(tmp_path_factory.mktemp("serving"))
    root = tmp_path_factory.getbasetemp().parent
    done = root / "torch_serving_ranks.pt"
    with open(root / "torch_serving_ranks.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                ranks = _spawn(root / "torch_serving_spawn")
                torch.save(ranks, root / "torch_serving_ranks.tmp")
                (root / "torch_serving_ranks.tmp").rename(done)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return torch.load(done, weights_only=False)

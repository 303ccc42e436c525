"""The sharded serving cases and their one spawn, shared by
``tests/test_torch_sharded_serving.py`` and ``tests/test_torch_dryrun.py``.

Five tiny cases on one (data 2, model 2) spawn of gloo CPU ranks, each at
f32 on the non-kernel route with the attention's bf16 operand rounding off
(``torch_mesh_workers.exact_f32_attention``), weights from the JAX
package's ``init_params`` (numpy, carried across by
``models.convert.params_from_jax``):

  deepseek   deepseek-7b, TP_ONLY_RULES: heads and kv heads cut, the
             vocab-parallel head; caches cut by heads
  olmo       olmo-1b, SMALL_MODEL_RULES, one prompt: weights whole over
             "model" (FSDP over "data"), caches cut by heads, the head
             outputs gathered before the whole o; the one row held whole
             on both data ranks
  granite    granite-moe-1b-a400m, SMALL_MODEL_RULES: EP in the prefill
             and the decode
  internlm2  internlm2-1.8b with one kv head, TP_ONLY_RULES: k and v
             gathered over "model", caches cut by sequence, the split-KV
             merge
  big        deepseek-7b, BIG_MODEL_RULES: FSDP gathers in serving
  fault      internlm2's case with rank 1's split-KV merge 2^-10 too large
             (``torch_mesh_workers.sharded_serve``)

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
RULES = {"deepseek": ("deepseek-7b", "TP_ONLY_RULES", {}, ROWS),
         "olmo": ("olmo-1b", "SMALL_MODEL_RULES", {}, 1),
         "granite": ("granite-moe-1b-a400m", "SMALL_MODEL_RULES", {}, ROWS),
         "internlm2": ("internlm2-1.8b", "TP_ONLY_RULES", {"n_kv_heads": 1}, ROWS),
         "big": ("deepseek-7b", "BIG_MODEL_RULES", {}, ROWS)}
CASES = tuple(RULES)
VOCAB_WITH_PAD = 250  # the planted greedy rows: 6 pad columns on the last model rank


def ref_params(arch: str, over: dict, dtype: str = "float32"):
    cfg = dataclasses.replace(ref_arch(arch, tiny=True), dtype=dtype, **over)
    return jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(3), cfg)[0])


def case(name: str, **kw) -> dict:
    arch, rules, over, rows = RULES[name]
    rng = np.random.default_rng(5)
    return dict(dict(arch=arch, rules=rules, cfg=over, params=ref_params(arch, over),
                     prompts=rng.integers(0, 256, (rows, PROMPT)).astype(np.int64),
                     decode=[rng.integers(0, 256, (rows, 1)).astype(np.int64)
                             for _ in range(STEPS)],
                     s_max=S_MAX, runs=2, meter=True), **kw)


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
    cases["fault"] = case("internlm2", fault=True, runs=1, meter=False)
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

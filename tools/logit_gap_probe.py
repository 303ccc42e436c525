#!/usr/bin/env python3
"""Where the tiny dense models' card-versus-CPU logit gap comes from, on one GPU.

    python3 tools/logit_gap_probe.py [--seeds 8]

``chip_smoke.py`` serves each tiny (f32) dense arch on the card, through
the kernels, and on the CPU, through their plain versions, from the same
weights, and holds the prefill logits of the two to a limit. Given the
same inputs every kernel agrees with its plain version within 1e-6, but
the inputs differ: the f32 ops outside the kernels (the projections, RoPE,
the residual adds) run in other orders on the card, and the kernels round
some operands to bf16 (attention's q, k, v and p, the norms' squares).
Where an f32 difference carries a value across a bf16 rounding boundary,
that operand moves by one bf16 ulp (2^-8 relative): a flip.

For tiny internlm2 (4 query heads on 2 kv heads), the same with 4 kv
heads, tiny deepseek (4 on 4) and the same with 2 kv heads, each from
``--seeds`` weight seeds, it prints:

  * the largest card-versus-CPU difference of the prefill logits;
  * the flips: elements of the kernels' rounded operands (attention's
    q, k, v; the norms' squares) whose bf16 rounding differs between the
    card's run and the CPU's;
  * the gap with a fault planted on the card's side: the kv heads mapped
    wrongly (query head h on kv head h mod Hkv where Hkv < Hq, the kv
    heads rolled by one where Hkv = Hq), the softmax scale 10% off, and
    1% off;
  * the card's GQA run against the same run with the kv heads expanded
    to the query heads in the right order (``repeat_interleave``), which
    takes the kernel's MHA path: the GQA indexing's own share of the gap.

It prints the card's name and power limit first and a JSON summary last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = (("internlm2-1.8b", None), ("internlm2-1.8b", 4), ("deepseek-7b", None),
            ("deepseek-7b", 2))
FAULTS = ("kv_map", 1.1, 1.01)


def _cpu_copy(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    return [_cpu_copy(v) for v in tree]


def _faulty_attention(real, fault):
    """``flash_attention_diff`` with ``fault`` planted: "kv_map", or a
    factor on the softmax scale."""

    def call(q, k, v, causal, window, q_offset, sm_scale):
        hq, hkv = q.shape[1], k.shape[1]
        if fault == "kv_expanded":  # the right mapping, on the MHA path
            k, v = (t.repeat_interleave(hq // hkv, 1) for t in (k, v))
        elif fault == "kv_map":
            if hkv < hq:
                k, v = k.repeat(1, hq // hkv, 1, 1), v.repeat(1, hq // hkv, 1, 1)
            else:
                k, v = k.roll(1, 1), v.roll(1, 1)
        else:
            sm_scale = fault * q.shape[-1] ** -0.5
        return real(q, k, v, causal, window, q_offset, sm_scale)

    return call


def prefill(eng, tokens, fault=None):
    """The engine's prefill logits, and the kernel calls' rounded operands
    in call order: ("attention", q, k, v) and ("norm", x)."""
    import torch

    from repro_torch import kernels as K

    real = {"flash_attention_diff": K.flash_attention_diff, "rmsnorm": K.rmsnorm}
    attention = real["flash_attention_diff"]
    if fault is not None:
        attention = _faulty_attention(attention, fault)
    calls = []

    def attn(q, k, v, *rest, **kw):
        calls.append(("attention", q, k, v))
        return attention(q, k, v, *rest, **kw)

    def norm(x, *rest, **kw):
        calls.append(("norm", x))
        return real["rmsnorm"](x, *rest, **kw)

    K.flash_attention_diff, K.rmsnorm = attn, norm
    try:
        with torch.inference_mode():
            logits, _ = eng._prefill(eng.params, tokens)
    finally:
        K.flash_attention_diff, K.rmsnorm = real["flash_attention_diff"], real["rmsnorm"]
    return logits.cpu(), calls


def flips(card_calls, cpu_calls) -> dict:
    """Elements whose bf16 rounding differs between the two runs, by operand."""
    import torch

    assert [c[0] for c in card_calls] == [c[0] for c in cpu_calls]
    out = {"q": 0, "k": 0, "v": 0, "norm_squares": 0}
    for a, b in zip(card_calls, cpu_calls):
        if a[0] == "attention":
            for name, x, y in zip("qkv", a[1:], b[1:]):
                out[name] += int((x.cpu().to(torch.bfloat16) != y.to(torch.bfloat16)).sum())
        else:
            x, y = a[1].cpu().float(), b[1].float()
            out["norm_squares"] += int(((x * x).to(torch.bfloat16)
                                        != (y * y).to(torch.bfloat16)).sum())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import GuardedEngine

    if not torch.cuda.is_available():
        print("logit_gap_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    build.library()
    summary = {}
    for arch, kv in VARIANTS:
        cfg = get_arch(arch, tiny=True)
        if kv is not None:
            cfg = dataclasses.replace(cfg, n_kv_heads=kv)
        label = f"{cfg.name} {cfg.n_heads}q/{cfg.n_kv_heads}kv"
        rng = np.random.default_rng(0)  # chip_smoke.py's prompts
        prompts = [rng.integers(0, cfg.vocab_size, size=(12,)) for _ in range(3)]
        tokens = torch.from_numpy(np.stack(prompts[:2]).astype(np.int64))
        rows = []
        for seed in range(args.seeds):
            gpu = GuardedEngine(cfg, 32, 2, seed=seed)
            cpu = GuardedEngine(cfg, 32, 2, device="cpu", params=_cpu_copy(gpu.params))
            lc, cpu_calls = prefill(cpu, tokens)
            lg, card_calls = prefill(gpu, tokens.cuda())
            row = {"seed": seed, "gap": float((lg - lc).abs().max()),
                   "logit_scale": float(lc.abs().max()), "flips": flips(card_calls, cpu_calls)}
            for fault in FAULTS:
                lf, _ = prefill(gpu, tokens.cuda(), fault)
                row[f"fault_{fault}"] = float((lf - lc).abs().max())
            le, _ = prefill(gpu, tokens.cuda(), "kv_expanded")
            row["gqa_vs_expanded"] = float((lg - le).abs().max())
            rows.append(row)
            print(f"{label} seed {seed}: gap {row['gap']:.3g} (logits up to "
                  f"{row['logit_scale']:.3g}), bf16 flips {row['flips']}, GQA vs expanded kv "
                  f"{row['gqa_vs_expanded']:.3g}; planted faults: "
                  + ", ".join(f"{f} {row[f'fault_{f}']:.3g}" for f in FAULTS))
            del gpu, cpu
        clean = [r["gap"] for r in rows]
        flipped = [r["gap"] for r in rows if sum(r["flips"].values())]
        unflipped = [r["gap"] for r in rows if not sum(r["flips"].values())]
        summary[label] = {
            "gap_max": max(clean), "gap_max_with_flips": max(flipped, default=None),
            "gap_max_without_flips": max(unflipped, default=None),
            "seeds_with_flips": len(flipped), "seeds": len(rows),
            "gqa_vs_expanded_max": max(r["gqa_vs_expanded"] for r in rows),
            **{f"fault_{f}_min": min(r[f"fault_{f}"] for r in rows) for f in FAULTS},
        }
        print(f"{label}: {summary[label]}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

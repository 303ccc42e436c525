"""Batched serving demo: prefill + multi-wave greedy decode on two cache
disciplines (a full KV cache for a dense arch, O(1) state for the SSM).

Port of ``examples/serve_batched.py``: the same two calls of
``launch.serve.main`` with the same flags (tiny olmo-1b, 6 requests over
3 slots; tiny mamba2-780m, 4 over 2; prompts of 16, 8 new tokens).

  python -m repro_torch.examples.serve_batched              # on the card
  python -m repro_torch.examples.serve_batched --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import resolve_device

RUNS = (
    ("dense arch (full KV cache)",
     ["--arch", "olmo-1b", "--tiny", "--requests", "6", "--batch-slots", "3",
      "--prompt-len", "16", "--max-new", "8"]),
    ("SSM arch (O(1) recurrent state, no KV growth)",
     ["--arch", "mamba2-780m", "--tiny", "--requests", "4", "--batch-slots", "2",
      "--prompt-len", "16", "--max-new", "8"]),
)


def main(argv=None) -> list:
    """Serve both; returns each run's outputs (a list of token lists a
    request), in ``RUNS`` order."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the GPU when unset")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    outs = []
    for i, (title, flags) in enumerate(RUNS):
        print(f"{chr(10) if i else ''}=== {title} ===")
        outs.append(serve_main(flags + ["--device", str(device)]))
    return outs


if __name__ == "__main__":
    main()

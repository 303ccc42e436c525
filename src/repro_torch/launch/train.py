"""Training driver: config -> seeded synthetic data -> train step -> loop.

Port of ``repro/launch/train.py``. Runs on the GPU unless given
``--device cpu``; with no GPU and no ``--device`` it raises. Parameters are
random from ``TrainConfig.seed``; the data is the seeded ``SyntheticLM``
stream, identical to the reference's for the same seed.

  python -m repro_torch.launch.train --arch olmo-1b --reduce-backend cuda_fused \\
      --steps 3 --batch 4 --seq 512
  python -m repro_torch.launch.train --arch olmo-1b --tiny --steps 2 --device cpu

Not ported yet, and refused with the ROADMAP item that ports them:
``--guard`` and ``--chaos`` (Queue 1, item 11, guarded training),
``--mesh`` (item 12, distributed) and ``--ckpt-dir`` (item 6,
checkpoints).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data import ShardInfo, SyntheticLM
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.convert import reference_leaf_groups

_NOT_PORTED = {
    "guard": "ROADMAP Queue 1, item 11 (guarded training)",
    "chaos": "ROADMAP Queue 1, item 11 (guarded training)",
    "mesh": "ROADMAP Queue 1, item 12 (distributed)",
    "ckpt_dir": "ROADMAP Queue 1, item 6 (checkpoints)",
}


def build(cfg, tcfg, device, params=None):
    """Parameters (seeded random unless given; they are set to require
    grad), optimizer state and the train step."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        params = init_params(cfg, gen, device)
    for p in R.tree_leaves(params):
        p.requires_grad_(True)
    opt_state = optim.init_state(
        params, fused_second_moment=tcfg.fused_second_moment,
        leaf_groups=reference_leaf_groups(params, cfg),
    )
    return params, opt_state, make_train_step(cfg, tcfg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument(
        "--fused-second-moment", action="store_true",
        help="olmax-style scalar v EMA per reference leaf, fed by the norm "
        "launch's per-leaf sumsq slots",
    )
    ap.add_argument(
        "--reduce-backend", default=None, choices=R.available_backends() + ("auto",),
        help="process-wide repro_torch.reduce backend (default: the config flags)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the plain versions)")
    for flag in ("--guard", "--mesh"):
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--chaos", type=float, default=0.0, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    for name, item in _NOT_PORTED.items():
        if getattr(args, name):
            ap.error(f"--{name.replace('_', '-')} is not ported yet: {item}")
    device = resolve_device(args.device)
    if args.reduce_backend:
        R.set_default_backend(args.reduce_backend)
    cfg = get_arch(args.arch, tiny=args.tiny)
    tcfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10), microbatches=args.microbatches,
        fused_second_moment=args.fused_second_moment,
    )
    params, opt_state, step_fn = build(cfg, tcfg, device)
    n_params = sum(p.numel() for p in R.tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M steps={args.steps} device={device}")

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, ShardInfo(), seed=tcfg.seed)
    losses = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = {"tokens": torch.from_numpy(data.next()["tokens"]).to(device)}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps:
            n = (step - 1) % args.log_every + 1
            dt = (time.time() - t0) / n
            print(
                f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f} ms/step"
            )
            t0 = time.time()
    return losses


if __name__ == "__main__":
    main()

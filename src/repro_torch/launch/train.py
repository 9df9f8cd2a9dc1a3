"""Training launcher CLI (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --mode bika --steps 3 --seq-len 128 --batch 4 [--ckpt /tmp/ck]

Runs on one CUDA device unless ``--device cpu`` is given; without a GPU it
raises. ``--smoke`` swaps in the reduced config. ``--ckpt DIR`` saves the
parameters and the optimizer state there (at the end of the run, and
every 25 steps) and resumes from the latest checkpoint it holds; a run
that finds its last step already there trains nothing. The reference's
mesh and FSDP flags have no counterpart yet (one device).
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint import latest_step
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.optim.adamw import OptimizerSpec
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_NAMES)
    ap.add_argument("--mode", default="bika", choices=("dense", "bika", "bnn", "qnn8"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: save there and resume from its latest step")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu (plain versions)")
    args = ap.parse_args(argv)

    getter = get_smoke if args.smoke else get_config
    arch = getter(args.arch, compute_mode=args.mode)
    cfg = TrainConfig(arch=arch, seq_len=args.seq_len, global_batch=args.batch,
                      microbatches=args.microbatches, steps=args.steps, ckpt_dir=args.ckpt,
                      log_every=max(args.steps // 20, 1))
    trainer = Trainer(cfg, OptimizerSpec(peak_lr=args.lr, total_steps=args.steps),
                      device=args.device)
    _, _, log = trainer.run()
    print(f"device={trainer.device} arch={arch.name} mode={arch.compute_mode} "
          f"layers={arch.n_layers} d_model={arch.d_model}")
    for m in log:
        print(f"step {m['step']:>6}  loss {m['loss']:.4f}  acc {m['accuracy']:.3f}")
    if args.ckpt:
        print(f"checkpoint step {latest_step(args.ckpt)} -> {args.ckpt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

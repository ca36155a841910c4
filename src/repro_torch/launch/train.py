"""Training launcher: config registry → seeded model with f32 masters →
train step → synthetic data → restartable loop with async checkpoints.

  python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke
  python -m repro_torch.launch.train --arch granite-20b --steps 100 \\
      --ckpt CKPT_DIR [--smoke] [--microbatches 2] [--seq 4096 --batch 256]
  python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke --device cpu

The JAX package's ``repro.launch.train`` on one device: the card unless
``--device`` names another. Its mesh flags (``--mesh``,
``--distributed-init``) wait for the port's mesh and sharding. A
checkpoint directory that holds a run resumes it from its newest step.
The last line: ``done: step=... loss[last5]=... rollbacks=... restarts=...
stragglers=...``.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-size); full config otherwise")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_config
    from ..data import DataConfig, synthetic_batch
    from ..models import transformer as tfm
    from ..optim import adamw
    from ..runtime import RuntimeConfig, run_training
    from ..train import TrainConfig, build_train_step

    cfg = get_config(args.arch, smoke=args.smoke)
    device = torch.device(args.device)
    print(f"arch={cfg.arch_id} device={device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    seq = args.seq or (128 if args.smoke else 4096)
    batch = args.batch or (8 if args.smoke else 256)
    tc = TrainConfig(optimizer=adamw.AdamWConfig(lr=args.lr), microbatches=args.microbatches)
    step_fn = build_train_step(cfg, tc, device)
    dcfg = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)

    def make_state():
        gen = torch.Generator(device=device).manual_seed(0)
        params = tfm.init_params(cfg, gen, device, master=True)
        return {"params": params, "opt": adamw.init_opt_state(params)}

    def wrapped_step(state, batch_):
        p, o, m = step_fn(state["params"], state["opt"], batch_)
        return {"params": p, "opt": o}, m

    rc = RuntimeConfig(ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every)
    res = run_training(
        steps=args.steps, make_state=make_state, step_fn=wrapped_step,
        batch_fn=lambda s: synthetic_batch(dcfg, s, device), rc=rc,
    )
    print(f"done: step={res.final_step} loss[last5]={np.mean(res.losses[-5:]):.4f} "
          f"rollbacks={res.rollbacks} restarts={res.restarts} "
          f"stragglers={res.straggler_events}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

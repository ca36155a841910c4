"""Training launcher: config registry → seeded model with f32 masters →
train step → synthetic data → restartable loop with async checkpoints.

  python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke
  python -m repro_torch.launch.train --arch granite-20b --steps 100 \\
      --ckpt CKPT_DIR [--smoke] [--microbatches 2] [--seq 4096 --batch 256]
  python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke --device cpu
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch olmoe-1b-7b \
      --mesh 2x2 --distributed-init

The JAX package's ``repro.launch.train``: on one device (the card unless
``--device`` names another), or with ``--distributed-init`` one process a
rank of a ("data", "model") process mesh (``--mesh``: ``auto``, a model
axis of 2 from 4 ranks on, else 1; ``single`` 16x16; ``multi`` 2x16x16
with "pod"; or ``DxM``). ``--distributed-init`` joins the process group
the launcher describes in the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the card): NCCL on
the card, gloo on the CPU. On a mesh the train step is tensor parallel
with ZeRO-1 (``train.step``), rank 0 writes the checkpoints and prints.
A checkpoint directory that holds a run resumes it from its newest step.
The last line: ``done: step=... loss[last5]=... rollbacks=... restarts=...
stragglers=...``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


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
    ap.add_argument("--mesh", default="auto",
                    help="auto | single | multi | DxM (e.g. 2x2); with --distributed-init")
    ap.add_argument("--distributed-init", action="store_true",
                    help="join the process group the environment describes")
    args = ap.parse_args(argv)
    if args.mesh != "auto" and not args.distributed_init:
        ap.error(f"--mesh {args.mesh} needs --distributed-init (one process a rank)")

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..configs import get_config
    from ..data import DataConfig, synthetic_batch
    from ..models import transformer as tfm
    from ..optim import adamw
    from ..runtime import RuntimeConfig, run_training
    from ..train import MeshState, TrainConfig, build_train_step
    from .mesh import make_mesh, make_production_mesh

    cfg = get_config(args.arch, smoke=args.smoke)
    device = torch.device(args.device)
    mesh = None
    if args.distributed_init:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        ndev = dist.get_world_size()
        if args.mesh in ("single", "multi"):
            mesh = make_production_mesh(multi_pod=args.mesh == "multi", device=device)
        else:
            model = 2 if ndev >= 4 else 1
            d, m = ((ndev // model, model) if args.mesh == "auto"
                    else (int(v) for v in args.mesh.split("x")))
            mesh = make_mesh((d, m), ("data", "model"), device)
    rank0 = mesh is None or mesh.rank == 0
    if rank0:
        print(f"arch={cfg.arch_id} device={device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
              + (f" mesh={mesh.shape}" if mesh is not None else ""))

    seq = args.seq or (128 if args.smoke else 4096)
    batch = args.batch or (8 if args.smoke else 256)
    tc = TrainConfig(optimizer=adamw.AdamWConfig(lr=args.lr), microbatches=args.microbatches)
    step_fn = build_train_step(cfg, tc, device, mesh=mesh, global_batch=batch)
    dcfg = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)

    def make_state():
        gen = torch.Generator(device=device).manual_seed(0)
        params = tfm.init_params(cfg, gen, device, master=True, mesh=mesh)
        return {"params": params,
                "opt": adamw.init_opt_state(params, mesh=mesh, specs=step_fn.specs)}

    def wrapped_step(state, batch_):
        p, o, m = step_fn(state["params"], state["opt"], batch_)
        return {"params": p, "opt": o}, m

    rc = RuntimeConfig(ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every)
    t0 = time.perf_counter()
    res = run_training(
        steps=args.steps, make_state=make_state, step_fn=wrapped_step,
        batch_fn=lambda s: synthetic_batch(dcfg, s, device), rc=rc,
        mesh=mesh, codec=MeshState(step_fn, mesh) if mesh is not None else None,
    )
    if rank0:
        print(f"{len(res.losses)} steps in {time.perf_counter() - t0:.1f} s, restore and "
              f"checkpoints included"
              + (f"; peak {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB on rank "
                 f"0's card" if device.type == "cuda" else ""))
        print(f"done: step={res.final_step} loss[last5]={np.mean(res.losses[-5:]):.4f} "
              f"rollbacks={res.rollbacks} restarts={res.restarts} "
              f"stragglers={res.straggler_events}")
    if args.distributed_init:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

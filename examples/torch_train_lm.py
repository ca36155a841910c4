"""End-to-end LM training on the PyTorch port: ``examples/train_lm.py``'s
counterpart. Trains a ~100M-class model for a few hundred steps with the
port's substrate: the tensor-parallel train step with AdamW and ZeRO-1,
the synthetic pipeline, async checkpointing and the fault-tolerant loop,
on a (data 2, model 2) process mesh, one process a rank (NCCL with a card
a rank, gloo otherwise: on the CPU, or ranks sharing cards).

The default is a reduced-width model sized for a CPU; ``--full-100m`` is
the 100M-parameter configuration (same code path, slower).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --device cpu
      PYTHONPATH=src python examples/torch_train_lm.py --arch mamba2-370m --smoke --device cpu
"""
import argparse
import tempfile

MESH = (2, 2)  # (data, model)


def _config(args):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import ModelConfig

    if args.arch:
        return get_config(args.arch, smoke=True)
    if args.full_100m:
        return ModelConfig(arch_id="lm-100m", n_layers=12, d_model=768, n_heads=12,
                           kv_heads=12, head_dim=64, d_ff=3072, vocab=32000, act="swiglu",
                           family="attn", dtype="float32")
    # 100M-class structure, reduced width for CPU throughput
    return ModelConfig(arch_id="lm-mini", n_layers=4, d_model=256, n_heads=8, kv_heads=4,
                       head_dim=32, d_ff=1024, vocab=4096, act="swiglu", family="attn",
                       dtype="float32")


def train_rank(mesh, args, ckpt_dir):
    """One rank: the loop over this rank's slices; (losses, final step,
    parameter count)."""
    import torch

    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import RuntimeConfig, run_training
    from repro_torch.train import MeshState, TrainConfig, build_train_step

    cfg, device = _config(args), mesh.device
    tc = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=20))
    step_fn = build_train_step(cfg, tc, device, mesh=mesh, global_batch=args.batch)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)

    def make_state():
        params = tfm.init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                                 master=True, mesh=mesh)
        return {"params": params,
                "opt": adamw.init_opt_state(params, mesh=mesh, specs=step_fn.specs)}

    def wrapped_step(state, batch):
        p, o, m = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    rc = RuntimeConfig(ckpt_dir=ckpt_dir, ckpt_every=max(args.steps // 4, 10))
    res = run_training(steps=args.steps, make_state=make_state, step_fn=wrapped_step,
                       batch_fn=lambda s: synthetic_batch(dcfg, s, device), rc=rc,
                       mesh=mesh, codec=MeshState(step_fn, mesh))
    n_params = sum(p.numel() for p in tfm.init_params(cfg, None, "meta").parameters())
    return [float(x) for x in res.losses], res.final_step, n_params


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default=None, help="train a smoke config of an arch")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.launch import spawn

    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    if args.device == "cuda" and not cards:
        ap.error("no card: pass --device cpu")
    backend = "nccl" if cards >= MESH[0] * MESH[1] else "gloo"
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="lm_ckpt_")
    ranks = spawn.run_mesh(train_rank, MESH, backend=backend, device=args.device,
                           args=(args, ckpt_dir), timeout_s=7200)
    losses, final_step, n_params = ranks[0]
    assert all(r[0] == losses for r in ranks), "the ranks hold different losses"
    print(f"arch={_config(args).arch_id} params={n_params / 1e6:.1f}M steps={final_step} "
          f"mesh (data, model)={MESH} backend={backend} device={args.device}")
    k = max(args.steps // 10, 1)
    print(f"loss: first {np.mean(losses[:k]):.3f} -> last {np.mean(losses[-k:]):.3f}")
    assert np.mean(losses[-k:]) < np.mean(losses[:k]), "loss must drop"
    print(f"checkpoints in {ckpt_dir}; OK")


if __name__ == "__main__":
    main()

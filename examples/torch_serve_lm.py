"""Batched LM serving with continuous batching on the PyTorch port:
``examples/serve_lm.py``'s counterpart.

Spins up the port's ``ServeEngine`` on a smoke-size model over a (data 1,
model 2) process mesh, one process a rank (NCCL with a card a rank,
gloo otherwise: on the CPU, or two ranks sharing one card), submits a
burst of requests with varying prompt lengths, and drives prefill +
lock-step decode to completion. Every rank runs the same host loop on the
same logits, so every rank must return the same tokens.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py --arch granite-20b --device cpu
      PYTHONPATH=src python examples/torch_serve_lm.py --arch zamba2-2.7b   # on cards
"""
import argparse

MESH = (1, 2)  # (data, model)
MAX_BATCH, S_MAX = 3, 64


def serve_rank(mesh, arch, requests, max_new):
    """One rank: the model's slices, the engine, the whole stream."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import EngineConfig, Request, ServeEngine

    cfg = get_config(arch, smoke=True)
    gen = torch.Generator(device=mesh.device).manual_seed(3)
    params = tfm.init_params(cfg, gen, mesh.device, mesh=mesh)
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=MAX_BATCH, s_max=S_MAX),
                      device=mesh.device, mesh=mesh)
    rng = np.random.default_rng(0)
    for rid in range(requests):
        plen = int(rng.integers(4, 12))
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
                           max_new_tokens=max_new))
    return [(r.rid, len(r.prompt), list(r.out_tokens))
            for r in sorted(eng.run_to_completion(), key=lambda r: r.rid)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    import torch

    from repro_torch.launch import spawn

    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    if args.device == "cuda" and not cards:
        ap.error("no card: pass --device cpu")
    backend = "nccl" if cards >= MESH[0] * MESH[1] else "gloo"
    print(f"arch={args.arch} mesh (data, model)={MESH} backend={backend} device={args.device}; "
          f"submitting {args.requests} requests (max_batch={MAX_BATCH} -> continuous "
          f"batching refills slots)")
    ranks = spawn.run_mesh(serve_rank, MESH, backend=backend, device=args.device,
                           args=(args.arch, args.requests, args.max_new))
    assert all(r == ranks[0] for r in ranks), "the ranks returned different tokens"
    for rid, plen, tokens in ranks[0]:
        print(f"  req{rid}: prompt_len={plen} generated={tokens}")
    assert len(ranks[0]) == args.requests
    print(f"OK — all requests completed, the same tokens on all {len(ranks)} ranks")


if __name__ == "__main__":
    main()

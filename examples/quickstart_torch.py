"""Quickstart for the PyTorch/CUDA port: build an architecture at smoke
size, run a forward pass, train a few steps, then serve it.

    PYTHONPATH=src python examples/quickstart_torch.py [--arch qwen3-14b]
                                                       [--device cuda|cpu]

On the GPU the attention runs through the hand-written flash kernel (and
its plain backward when training) and paged decode through the paged
attention kernel; ``--device cpu`` runs their plain PyTorch versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import ARCH_IDS, build_model, get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.memory.accounting import tree_leaves  # noqa: E402
from repro_torch.runtime import optim  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402
from repro_torch.runtime.train import TrainConfig, make_train_step  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    print(f"[quickstart] {args.arch} (reduced): {cfg.num_layers}L "
          f"d={cfg.d_model} heads={cfg.num_heads} vocab={cfg.vocab} on {dev}")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[quickstart] {n_params / 1e6:.2f}M parameters")

    # --- forward ---
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen).to(dev)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = np.zeros((2, cfg.encoder_seq, cfg.d_model),
                                   np.float32)
    if cfg.family == "vlm":
        extra["patches"] = np.zeros((2, cfg.num_patches, cfg.d_model),
                                    np.float32)
    with torch.no_grad():
        logits = model.forward(params, tokens, {
            k: torch.from_numpy(v).to(dev) for k, v in extra.items()} or None)
    print(f"[quickstart] forward: logits {tuple(logits.shape)}")

    # --- train a few steps ---
    tcfg = TrainConfig(adamw=optim.AdamWConfig(
        lr=3e-3, warmup_steps=2, total_steps=max(args.steps, 4)))
    step = make_train_step(model, tcfg)
    opt = optim.init_opt_state(params)
    data = SyntheticLM(DataConfig(batch=4, seq=32, vocab=cfg.vocab))
    for i in range(args.steps):
        batch = data.batch_at(i)
        batch.update({k: np.repeat(v, 2, axis=0) for k, v in extra.items()})
        params, opt, m = step(params, opt, batch)
        if i % 2 == 0 or i == args.steps - 1:
            print(f"[quickstart] step {i}: loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e}")

    # --- serve (the decoder families; whisper has no server path) ---
    if cfg.family != "encdec":
        server = BatchedServer(model, params, batch_size=2, max_seq=64,
                               device=dev)
        req = server.submit(np.asarray([1, 2, 3], np.int32),
                            max_new_tokens=8)
        server.run_once()
        print(f"[quickstart] served tokens: {req.output}")
    print("[quickstart] OK")


if __name__ == "__main__":
    main()

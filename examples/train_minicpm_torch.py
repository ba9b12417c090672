"""Train a MiniCPM-family model with the port's full training stack: the
WSD schedule, gradient accumulation, the fault-tolerant loop with async
checkpoints, and the prefetching data pipeline.

    PYTHONPATH=src python examples/train_minicpm_torch.py --steps 300
                                                 [--device cuda|cpu]

The defaults are ~100M parameters (6 layers of d 384, vocab 32768); on
the GPU the attention is the hand-written flash kernel under autograd.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import build_model, get_config  # noqa: E402
from repro_torch.data.pipeline import (DataConfig,  # noqa: E402
                                       PrefetchingLoader, SyntheticLM)
from repro_torch.memory.accounting import tree_leaves  # noqa: E402
from repro_torch.runtime import optim  # noqa: E402
from repro_torch.runtime.ft import FaultTolerantLoop, FTConfig  # noqa: E402
from repro_torch.runtime.train import TrainConfig, make_train_step  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # a MiniCPM-family config (WSD schedule, as in the paper)
    cfg = get_config("minicpm-2b").reduced(
        num_layers=args.layers, d_model=args.d_model, num_heads=6,
        num_kv_heads=6, d_ff=args.d_model * 4, vocab=args.vocab,
        head_dim=args.d_model // 6)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] minicpm-family: {n / 1e6:.1f}M params, "
          f"{cfg.num_layers}L d={cfg.d_model} on {dev}")

    tcfg = TrainConfig(
        adamw=optim.AdamWConfig(lr=6e-3, schedule="wsd", warmup_steps=20,
                                total_steps=args.steps, decay_fraction=0.2),
        accum_steps=2)
    step_fn = make_train_step(model, tcfg)
    opt = optim.init_opt_state(params)
    dcfg = DataConfig(batch=args.batch, seq=args.seq, vocab=cfg.vocab)
    loader = PrefetchingLoader(SyntheticLM(dcfg), dcfg)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="minicpm_ckpt_")
    losses = []

    def ft_step(state, i):
        p, o = state
        p, o, m = step_fn(p, o, next(loader))
        losses.append(float(m["loss"]))
        if i % 25 == 0:
            print(f"[train] step {i:4d} loss {losses[-1]:.4f} "
                  f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f}")
        return (p, o), m

    loop = FaultTolerantLoop(
        FTConfig(ckpt_dir=ckpt_dir, ckpt_every=100, async_save=True), ft_step)
    try:
        (params, opt), end = loop.run((params, opt), num_steps=args.steps)
    finally:
        loader.close()
    k = max(1, min(10, len(losses) // 2))
    print(f"[train] done at step {end}; loss {np.mean(losses[:k]):.3f} -> "
          f"{np.mean(losses[-k:]):.3f}; checkpoints in {ckpt_dir}; "
          f"straggler flags {loop.monitor.flags}, "
          f"backup batches {loader.backup_batches}")
    assert np.mean(losses[-k:]) < np.mean(losses[:k])
    print("[train] OK")


if __name__ == "__main__":
    main()

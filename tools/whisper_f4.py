#!/usr/bin/env python3
"""whisper-base's bf16 decoder, the port against the reference, on the CPU
at smoke size over several seeds (F4): for each seed, the prefill's
last-position logits' max |d| and its excess over the paged bf16 bound
(|d| - 0.02 |want|, held to 0.1), the worst max |d| over 8 greedy steps
fed the reference's tokens, and the greedy first-8 match rate -- once
with the port's ``F.gelu`` and once with GELU computed as the
reference's backend computes it (op by op in bf16, bf16 constants).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/whisper_f4.py [--seeds N]

Imports both packages, as the tests do.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import build_model, get_config
from repro_torch.bridge import config_from_reference, params_from_reference
from repro_torch.configs import build_model as port_build
from repro_torch.models import layers as PL


def gelu_like_jax(x: torch.Tensor) -> torch.Tensor:
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=torch.float32).to(
        x.dtype).item()
    k = torch.tensor(0.044715, dtype=torch.float32).to(x.dtype).item()
    return x * (0.5 * (1 + torch.tanh(c * (x + k * (x * x * x)))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args()
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_config("whisper-base").reduced(),
                              dtype=jnp.bfloat16, remat=False)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = port_build(config_from_reference(cfg))
    pp = params_from_reference(jax.tree.map(np.asarray, params),
                               device="cpu")
    step = jax.jit(ref.decode_step)
    plain = PL.F.gelu

    def run(seed: int, like_jax: bool):
        PL.F.gelu = ((lambda x, approximate="tanh": gelu_like_jax(x))
                     if like_jax else plain)
        try:
            rng = np.random.RandomState(seed)
            frames = rng.randn(2, cfg.encoder_seq, cfg.d_model).astype(
                np.float32)
            toks = rng.randint(0, 512, (2, 9)).astype(np.int32)
            rl, rc = ref.prefill(params, jnp.asarray(toks),
                                 ref.init_cache(2, 32),
                                 extra={"frames": jnp.asarray(frames)})
            pl_, pc = port.prefill(pp, torch.from_numpy(toks),
                                   port.init_cache(2, 32, device="cpu"),
                                   extra={"frames": torch.from_numpy(frames)})
            want = np.asarray(rl, np.float32)
            d = np.abs(pl_.float().numpy() - want)
            first, over = float(d.max()), float((d - 0.02 * np.abs(want)).max())
            worst, match = first, 0
            for i in range(8):
                rt = np.asarray(rl, np.float32)[:, 0].argmax(-1)
                pt = pl_.float()[:, 0].argmax(-1).numpy()
                match += int((rt == pt).sum())
                cur = np.full((2,), 9 + i, np.int32)
                feed = rt[:, None].astype(np.int32)
                rl, rc = step(params, jnp.asarray(feed), rc, jnp.asarray(cur))
                pl_, pc = port.decode_step(pp, torch.from_numpy(feed), pc,
                                           torch.from_numpy(cur))
                worst = max(worst, float(np.abs(
                    pl_.float().numpy() - np.asarray(rl, np.float32)).max()))
            return first, over, worst, match / 16
        finally:
            PL.F.gelu = plain

    rows = {False: [], True: []}
    for seed in range(args.seeds):
        for like_jax in (False, True):
            rows[like_jax].append(run(seed, like_jax))
        a, b = rows[False][-1], rows[True][-1]
        print(f"seed {seed}: F.gelu prefill {a[0]:.4f} (over {a[1]:.4f}), "
              f"steps {a[2]:.4f}, first-8 {a[3]:.2f} | as jax: prefill "
              f"{b[0]:.4f} (over {b[1]:.4f}), steps {b[2]:.4f}, first-8 "
              f"{b[3]:.2f}")
    for like_jax, name in ((False, "F.gelu"), (True, "GELU as jax")):
        r = np.asarray(rows[like_jax])
        print(f"{name}: mean prefill {r[:, 0].mean():.4f}, worst {r[:, 0].max():.4f}; "
              f"seeds within the bound at prefill {(r[:, 1] <= 0.1).sum()}"
              f"/{len(r)}; mean worst step {r[:, 2].mean():.4f}; mean "
              f"first-8 {r[:, 3].mean():.3f}")


if __name__ == "__main__":
    main()

"""Optimizer and schedules (counterpart of ``repro.runtime.optim``):
AdamW, the const, cosine and WSD (Warmup-Stable-Decay, MiniCPM
arXiv:2404.06395) learning-rate schedules, and int8 gradient compression
with error feedback.

Plain functions over the port's param trees (nested dicts and lists of
tensors), with the reference's arithmetic: weight decay joins the Adam
direction, ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` (not
``torch.optim.AdamW``'s decoupled ``p * (1 - lr * wd)``), applies to every
leaf, and the update runs in fp32 and is cast back to the param's dtype;
the global-norm clip scales the gradient before the moments.  Where the
reference returns new trees, :func:`adamw_update` writes the new params
and moments into the given leaves in place (the tree's fp32 moments are
four times a bf16 model's bytes, which a second copy would double).
Every scalar of a step (the step count, the learning rate, the clip
scale) stays a tensor on the params' device: a step makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.memory.accounting import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"        # 'cosine' | 'wsd' | 'const'
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_fraction: float = 0.1     # WSD: the last 10% of steps decay


def schedule_value(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in fp32 as the
    reference computes it."""
    s = step.to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm
    if cfg.schedule == "cosine":
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))
    if cfg.schedule == "wsd":
        # warmup -> stable (lr) -> decay over the last decay_fraction of
        # the steps, exponentially to 0.1x, as in MiniCPM
        decay_start = cfg.total_steps * (1.0 - cfg.decay_fraction)
        in_decay = torch.clamp((s - decay_start)
                               / max(cfg.total_steps - decay_start, 1),
                               0.0, 1.0)
        return cfg.lr * warm * torch.pow(
            torch.tensor(0.1, dtype=torch.float32, device=s.device), in_decay)
    raise ValueError(cfg.schedule)


def init_opt_state(params: Any) -> dict:
    """Step 0 and fp32 zero moments shaped like the params, on their
    devices."""
    dev = next(tree_leaves(params)).device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: dict) -> tuple[Any, dict, dict]:
    """One AdamW step, in place: returns (params, state, {"grad_norm",
    "lr"}), the first two the given trees with their leaves updated."""
    step = state["step"] + 1
    lr = schedule_value(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    sf = step.to(torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(torch.full_like(sf, b1), sf)
    bc2 = 1.0 - torch.pow(torch.full_like(sf, b2), sf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Gradient compression (int8 + error feedback): the distributed-optimizer
# trick for bandwidth-bound data parallelism.
# ---------------------------------------------------------------------------

def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = (g.abs().max() + 1e-12) / 127.0
    return _quantize(g, scale), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_stacked(gs: list, es: list) -> list:
    """[(dequantized gradient, new error)] of the gradients ``gs`` plus
    their errors ``es``, quantized to int8 as one stacked leaf: one scale,
    from their joint absmax."""
    totals = [g.float() + e for g, e in zip(gs, es)]
    scale = (torch.stack([t.abs().max() for t in totals]).max()
             + 1e-12) / 127.0
    out = []
    for t in totals:
        deq = decompress_int8(_quantize(t, scale), scale)
        out.append((deq, t - deq))
    return out


def compressed_grad(g: torch.Tensor, err: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize g + err to int8; returns (the dequantized gradient, the
    new error)."""
    return _compress_stacked([g], [err])[0]


def compressed_grads(grads: Any, err: Any) -> tuple[Any, Any]:
    """:func:`compressed_grad` over a tree -> (dequantized gradients, new
    errors), as the reference applies it to its stacked tree: a list (the
    port's unstacked layer or group axis) shares one scale per leaf
    across its entries, the reference's stacked leaf's absmax."""
    if isinstance(grads, dict):
        parts = {k: compressed_grads(grads[k], err[k]) for k in grads}
        return ({k: p[0] for k, p in parts.items()},
                {k: p[1] for k, p in parts.items()})
    if isinstance(grads, list):
        # cols[j][i]: (deq, err) of leaf j of entry i
        cols = [_compress_stacked(list(gs), list(es)) for gs, es in zip(
            zip(*(list(tree_leaves(g)) for g in grads)),
            zip(*(list(tree_leaves(e)) for e in err)))]
        out: tuple[list, list] = ([], [])
        for i, g in enumerate(grads):
            for j in (0, 1):
                it = iter(col[i][j] for col in cols)
                out[j].append(tree_map(lambda _: next(it), g))
        return out
    return compressed_grad(grads, err)

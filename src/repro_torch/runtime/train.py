"""Training step (counterpart of ``repro.runtime.train``): the causal LM
loss in sequence chunks, gradient accumulation over microbatches,
optional int8 gradient compression with error feedback, and AdamW.

The loss runs the model's ``forward_hidden`` (every family has one), then
the LM head and cross entropy in chunks of :data:`LOSS_CHUNK` positions,
each chunk recomputed in the backward pass, so fp32 logits never exist
at (B, S, V).  Labels of -1 are masked, padded vocab columns are masked,
VLM patch positions are dropped, and the z-loss (``z_loss`` x the
squared log-partition) is added.  ``TrainConfig.moe_aux_weight`` is
carried but never added, as in the reference (ROADMAP R5).

Gradients come from ``torch.autograd.grad`` over detached leaves of the
param tree; the step then updates the params and moments in place
(:func:`repro_torch.runtime.optim.adamw_update`).  Batches arrive as
numpy (or tensor) dicts and are moved to the params' device.  Weights
paged from the remote tier are refused: the Tensor Prefetcher's window
slots are overwritten layer after layer and no gradient reaches the
packed host copies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.memory.accounting import tree_leaves, tree_map
from repro_torch.models import layers as L
from repro_torch.models.transformer import vocab_mask_logits
from repro_torch.runtime import optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: optim.AdamWConfig = dataclasses.field(
        default_factory=optim.AdamWConfig)
    accum_steps: int = 1
    moe_aux_weight: float = 0.01     # never added (the reference's loss)
    compress_grads: bool = False
    z_loss: float = 1e-4


LOSS_CHUNK = 512


def _chunk_ce(model, embed: dict, hidden: torch.Tensor,
              labels: torch.Tensor, z_loss: float):
    """(summed cross entropy + z-loss, count of unmasked labels) over one
    sequence chunk; the logits in fp32 at (B, chunk, V) only."""
    cfg = model.cfg
    logits = vocab_mask_logits(L.lm_head(embed, hidden, cfg),
                               cfg.vocab).float()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.clamp_min(0)[..., None],
                              dim=-1)[..., 0]
    nll = ((lse - ll) * mask).sum()
    zl = (lse.square() * mask).sum() * z_loss
    return nll + zl, mask.sum()


def lm_loss(model, params: dict, batch: dict, *,
            z_loss: float = 0.0) -> torch.Tensor:
    """Next-token cross entropy (mean over unmasked labels, plus the
    z-loss) of a batch of tensors: ``tokens`` and ``labels`` (B, S),
    ``patches`` (VLM) or ``frames`` (encoder-decoder) when the model
    takes them."""
    extra = {k: v for k, v in batch.items() if k in ("patches", "frames")}
    tokens = batch["tokens"]
    hidden = model.forward_hidden(params, tokens, extra or None)
    offs = hidden.shape[1] - tokens.shape[1]
    if offs:                                  # VLM: drop patch positions
        hidden = hidden[:, offs:]
    # predict token t + 1 from position t
    hidden = hidden[:, :-1]
    labels = batch["labels"][:, 1:].long()
    s = hidden.shape[1]
    chunk = min(LOSS_CHUNK, s)
    pad = (-s) % chunk
    if pad:   # pad to a chunk multiple; padded labels are masked (-1)
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s += pad

    def ce(h, lab):
        return _chunk_ce(model, params["embed"], h, lab, z_loss)

    total, count = 0.0, 0.0
    for i in range(0, s, chunk):
        t, c = L.checkpointed(ce, True, hidden[:, i:i + chunk],
                              labels[:, i:i + chunk])
        total, count = total + t, count + c
    return total / torch.clamp_min(count, 1.0)


def pages_weights(model) -> bool:
    """Whether the model's orchestrator pages weights from the remote
    tier (the Tensor Prefetcher's layers, or expert paging)."""
    return bool(model.mem.config.enabled
                or model.mem.expert_policy is not None)


def to_device(batch: dict, device: torch.device) -> dict:
    """A numpy (or tensor) batch on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def _loss_and_grads(model, tcfg: TrainConfig, params: dict, micro: dict):
    """(loss, the gradient of each param leaf) of one (micro)batch."""
    flat = list(tree_leaves(params))
    live = [p.detach().requires_grad_() for p in flat]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    loss = lm_loss(model, tree, micro, z_loss=tcfg.z_loss)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, flat)]


def loss_and_grads(model, tcfg: TrainConfig, params: dict, batch: dict):
    """(loss, [gradient of each param leaf]) of a batch on the params'
    device.  With ``accum_steps`` n > 1 the batch splits into n
    microbatches along its first dim; their gradients are summed in fp32
    and divided by n, as is the loss."""
    n = tcfg.accum_steps
    if n <= 1:
        return _loss_and_grads(model, tcfg, params, batch)
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} is not a multiple of accum_steps {n}")
    mb = b // n
    grads, lsum = None, 0.0
    for i in range(n):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss_i, g = _loss_and_grads(model, tcfg, params, micro)
        if grads is None:
            grads = [torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device) for x in g]
        for acc, x in zip(grads, g):
            acc.add_(x.float())
        lsum = lsum + loss_i
        del g
    for acc in grads:
        acc.div_(n)
    return lsum / n, grads


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch[, err_state]) ->
    (params, opt_state, metrics[, err_state])``: metrics ``loss``,
    ``grad_norm`` and ``lr``, 0-d tensors on the params' device; params,
    moments and the error feedback updated in place."""

    def train_step(params: dict, opt_state: dict, batch: dict,
                   err_state: Any = None):
        if pages_weights(model):
            raise ValueError(
                "training over weights paged from the remote tier (the "
                "Tensor Prefetcher's layer window, expert paging) is not "
                "ported: the window's slots are overwritten layer after "
                "layer and no gradient reaches the packed host weights; "
                "train with resident weights")
        batch = to_device(batch, next(tree_leaves(params)).device)
        loss, grads = loss_and_grads(model, tcfg, params, batch)
        if tcfg.compress_grads and err_state is not None:
            it = iter(grads)
            grads, err = optim.compressed_grads(
                tree_map(lambda _: next(it), params), err_state)
            for e, new in zip(tree_leaves(err_state), tree_leaves(err)):
                e.copy_(new)
        params, opt_state, om = optim.adamw_update(tcfg.adamw, params, grads,
                                                   opt_state)
        metrics = {"loss": loss, **om}
        if err_state is not None:
            return params, opt_state, metrics, err_state
        return params, opt_state, metrics

    return train_step

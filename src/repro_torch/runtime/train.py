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

Over a ``("data", "model")`` mesh of ranks (``make_train_step(model,
tcfg, mesh)``, the reference's pjit-ed step): each rank holds its
``"model"`` shards of the params as ``model.param_specs()`` places them
(row-parallel, the output projections by their contraction rows;
``sharding.shard_tree``), its ``"data"`` shard of the batch
(:func:`shard_batch`: its rows of each microbatch) and its ZeRO-1 shards
of the moments (``optim.init_opt_state(params, mesh=, specs=)``).  The
forward and backward run under the ambient mesh, row-parallel: every
tensor-parallel boundary is an autograd function over the TAB
(``repro_torch.core.tab``: ``enter_ranks`` where replicated activations
enter a rank's columns, ``sum_partials`` for the partial products,
``gather_for_local`` / ``gather_replicated`` for the gathers), so each
rank's gradients are those of its shards.  The loss keeps the vocab
sharded, as the reference's one-hot contraction lets GSPMD do: each rank
takes its columns' log-sum-exp and the label's logit (non-zero on its
owner only), and only ``(B, chunk)`` tensors cross the ranks.  A
microbatch's loss is its global summed loss over its global count of
labels (the counts all-reduced over ``"data"`` first), so each rank's
gradients summed over ``"data"`` are the global batch's; the sums go to
:func:`repro_torch.runtime.optim.zero1_apply`.  MoE configs are refused
over a mesh (expert-parallel training is not ported).
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
from repro_torch.runtime import optim, sharding


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
    sequence chunk; the logits in fp32 at (B, chunk, V) only -- over a
    mesh this rank's (B, chunk, V / model) columns, whose log-sum-exp and
    label logit are gathered as (B, chunk) pieces."""
    cfg = model.cfg
    mask = (labels >= 0).float()
    mesh, m = sharding.ambient_mesh(), sharding.model_shards()
    local = L.lm_head_local(embed, hidden, cfg)
    width = local.shape[-1]
    off = mesh.axis_index("model") * width if m > 1 else 0
    logits = vocab_mask_logits(local, cfg.vocab - off).float()
    mine = labels - off
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, mine.clamp(0, width - 1)[..., None],
                              dim=-1)[..., 0]
    if m > 1:
        # the label's logit lies in its owner's columns only
        from repro_torch.core.tab import gather_replicated
        ll = torch.where((mine >= 0) & (mine < width), ll,
                         torch.zeros_like(ll))
        every = gather_replicated(torch.stack([lse, ll]), "model", 0,
                                  mesh=mesh).view(m, 2, *lse.shape)
        lse, ll = torch.logsumexp(every[:, 0], dim=0), every[:, 1].sum(0)
    nll = ((lse - ll) * mask).sum()
    zl = (lse.square() * mask).sum() * z_loss
    return nll + zl, mask.sum()


def label_count(batch: dict) -> torch.Tensor:
    """The unmasked next-token labels of a batch (what :func:`lm_loss`
    divides by), as an fp32 0-d tensor."""
    return (batch["labels"][:, 1:] >= 0).sum().float()


def lm_loss(model, params: dict, batch: dict, *,
            z_loss: float = 0.0, count: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Next-token cross entropy (mean over unmasked labels, plus the
    z-loss) of a batch of tensors: ``tokens`` and ``labels`` (B, S),
    ``patches`` (VLM) or ``frames`` (encoder-decoder) when the model
    takes them.  ``count``: the labels to divide by (a data-parallel
    rank's shard passes the global microbatch's; default its own)."""
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

    total, mine = 0.0, 0.0
    for i in range(0, s, chunk):
        t, c = L.checkpointed(ce, True, hidden[:, i:i + chunk],
                              labels[:, i:i + chunk])
        total, mine = total + t, mine + c
    return total / torch.clamp_min(mine if count is None else count, 1.0)


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


def _loss_and_grads(model, tcfg: TrainConfig, params: dict, micro: dict,
                    count: torch.Tensor | None = None):
    """(loss, the gradient of each param leaf) of one (micro)batch."""
    flat = list(tree_leaves(params))
    live = [p.detach().requires_grad_() for p in flat]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    loss = lm_loss(model, tree, micro, z_loss=tcfg.z_loss, count=count)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, flat)]


def _micros(batch: dict, n: int) -> list[dict]:
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} is not a multiple of accum_steps {n}")
    mb = b // n
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(n)]


def _mesh_sums(model, tcfg: TrainConfig, params: dict, batch: dict, mesh,
               plan: optim.ZeroPlan):
    """(the global loss, this rank's fp32 gradient sums in ``plan``'s
    stacked layout, its mean over microbatches, not yet reduced over
    ``"data"``) of this rank's batch shard, under the ambient mesh."""
    td = mesh.transport("data")
    micros = _micros(batch, max(tcfg.accum_steps, 1))
    # every microbatch's label count over the data axis, before its loss
    counts = td.all_reduce(torch.stack([label_count(m) for m in micros]))
    dev = next(tree_leaves(params)).device
    accs = plan.accumulators(dev)
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    with sharding.activate_mesh(mesh, row_parallel=True):
        for i, micro in enumerate(micros):
            loss_i, g = _loss_and_grads(model, tcfg, params, micro, counts[i])
            plan.accumulate(accs, g)
            lsum = lsum + loss_i
            del g
    if len(micros) > 1:
        for acc in accs:
            acc.div_(len(micros))
    loss = td.all_reduce(lsum.reshape(1))[0] / len(micros)
    return loss, accs


def loss_and_grads(model, tcfg: TrainConfig, params: dict, batch: dict,
                   mesh=None):
    """(loss, [gradient of each param leaf]) of a batch on the params'
    device.  With ``accum_steps`` n > 1 the batch splits into n
    microbatches along its first dim; their gradients are summed in fp32
    and divided by n, as is the loss.  Over a ``mesh`` of several ranks
    ``params`` and ``batch`` are this rank's (:func:`shard_batch`): the
    global loss and the gradients of this rank's param shards, in fp32,
    all-reduced over ``"data"``."""
    if mesh is not None and mesh.size > 1:
        plan = optim.zero1_plan(params, model.param_specs(), mesh)
        loss, accs = _mesh_sums(model, tcfg, params, batch, mesh, plan)
        td = mesh.transport("data")
        out = [None] * len(list(tree_leaves(params)))
        for leaf, acc in zip(plan.leaves, accs):
            acc = td.all_reduce(acc)
            for j, i in enumerate(leaf.index):
                out[i] = acc[j] if leaf.stacked else acc
        return loss, out
    n = tcfg.accum_steps
    if n <= 1:
        return _loss_and_grads(model, tcfg, params, batch)
    grads, lsum = None, 0.0
    for micro in _micros(batch, n):
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


PAGED_REASON = ("training over weights paged from the remote tier (the "
                "Tensor Prefetcher's layer window, expert paging) is not "
                "ported: the window's slots are overwritten layer after "
                "layer and no gradient reaches the packed host weights; "
                "train with resident weights")
MOE_MESH_REASON = ("training an MoE over a mesh needs expert-parallel "
                   "training (the experts' dispatch and combine "
                   "differentiated over the model axis), which is not "
                   "ported; train it on one card")


def mesh_train_refusal(model) -> str | None:
    """Why ``model`` cannot take a training step over a mesh of several
    ranks (None when it can): an MoE (expert-parallel training), or
    weights paged from the remote tier."""
    if model.cfg.num_experts:
        return MOE_MESH_REASON
    if pages_weights(model):
        return PAGED_REASON
    return None


def shard_batch(batch: dict, mesh, accum_steps: int = 1) -> dict:
    """This rank's rows of a global batch (numpy or tensors): its
    ``"data"`` shard of each of the ``accum_steps`` microbatches (the
    reference's ``micro_split`` of a batch sharded over ``"data"``),
    microbatch after microbatch; the whole batch without a data axis."""
    d = 1 if mesh is None else mesh.axis_size("data")
    if d == 1:
        return batch
    r, n = mesh.axis_index("data"), max(accum_steps, 1)
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % (n * d):
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches of {d} data shards")
        mb = b // n
        c = mb // d
        rows = [v[i * mb + r * c: i * mb + (r + 1) * c] for i in range(n)]
        out[k] = (torch.cat(rows) if isinstance(v, torch.Tensor)
                  else np.concatenate(rows))
    return out


def make_train_step(model, tcfg: TrainConfig, mesh=None) -> Callable:
    """Returns ``train_step(params, opt_state, batch[, err_state]) ->
    (params, opt_state, metrics[, err_state])``: metrics ``loss``,
    ``grad_norm`` and ``lr``, 0-d tensors on the params' device; params,
    moments and the error feedback updated in place.  Over a ``mesh`` of
    several ranks (bound, inside the ranks ``launch.mesh.spawn`` starts)
    each rank passes its shards: params by ``model.param_specs()``, the
    moments and error feedback of ``optim.init_opt_state`` /
    ``optim.init_error_feedback`` with ``mesh=`` and ``specs=``, its
    batch rows (:func:`shard_batch`); the model's orchestrator is bound
    to the mesh, row-parallel.  A mesh of one rank is the one-card
    step."""
    multi = mesh is not None and mesh.size > 1
    if multi:
        reason = mesh_train_refusal(model)
        if reason is not None:
            raise ValueError(reason)
        if not mesh.bound:
            raise ValueError(f"{mesh!r} has no transports: train over a "
                             f"mesh inside the ranks launch.mesh.spawn "
                             f"starts")
        model.mem.bind_mesh(mesh, row_parallel=True)

    def mesh_step(params, opt_state, batch, err_state):
        plan = optim.zero1_plan(params, model.param_specs(), mesh)
        loss, accs = _mesh_sums(model, tcfg, params, batch, mesh, plan)
        om = optim.zero1_apply(
            tcfg.adamw, params, accs, opt_state, plan,
            err=err_state if tcfg.compress_grads else None)
        return {"loss": loss, **om}

    def train_step(params: dict, opt_state: dict, batch: dict,
                   err_state: Any = None):
        if pages_weights(model):
            raise ValueError(PAGED_REASON)
        batch = to_device(batch, next(tree_leaves(params)).device)
        if multi:
            metrics = mesh_step(params, opt_state, batch, err_state)
            if err_state is not None:
                return params, opt_state, metrics, err_state
            return params, opt_state, metrics
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

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

Over a ``(data, model)`` mesh the moments are ZeRO-1 shards (the
reference's ``opt_state_specs`` extended by its dry run's ``zero1``
rule): each fp32 moment of the reference's stacked tree is sharded over
``"data"`` on its first dim that no model axis shards and that ``data``
divides -- for a stacked group (``layers``, ``groups``, ...) that is the
layer axis when it divides, so a rank then holds whole layers' moments.
:func:`zero1_plan` lays the port's params (layers a list) over that
stacked tree; :func:`init_opt_state` with ``mesh`` gives this rank's
shards in the reference's structure (:func:`zero1_specs` is its spec
tree, for ``sharding.gather_tree`` and ``checkpoint.restore``), and
:func:`zero1_apply` takes a step from this rank's fp32 gradient sums:
reduced over ``"data"`` (a reduce-scatter onto the shard, an all-reduce
where a leaf has no ZeRO-1 dim), int8-compressed with a scale from the
whole leaf's absmax, clipped by the global norm (each element counted
once), applied to the shard with the one-card arithmetic, and the
updated shards all-gathered over ``"data"`` into the params.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.launch.mesh import P
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


def init_opt_state(params: Any, *, mesh=None, specs: Any = None) -> dict:
    """Step 0 and fp32 zero moments shaped like the params, on their
    devices; over a mesh of several ranks (``specs``: the model's
    ``param_specs``, ``params`` this rank's shards) this rank's ZeRO-1
    shards in the reference's stacked structure (:func:`zero1_plan`)."""
    dev = next(tree_leaves(params)).device
    if mesh is not None and mesh.size > 1:
        plan = zero1_plan(params, specs, mesh)
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": plan.zeros(dev), "v": plan.zeros(dev)}

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
    bc1, bc2 = _bias_corrections(cfg, step)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        p.copy_(_adamw_leaf(cfg, p.float(), g, m, v, scale, lr, bc1, bc2))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    sf = step.to(torch.float32)
    return (1.0 - torch.pow(torch.full_like(sf, cfg.b1), sf),
            1.0 - torch.pow(torch.full_like(sf, cfg.b2), sf))


def _adamw_leaf(cfg: AdamWConfig, p32: torch.Tensor, g: torch.Tensor,
                m: torch.Tensor, v: torch.Tensor, scale, lr, bc1, bc2
                ) -> torch.Tensor:
    """One leaf's (or shard's) AdamW: the moments updated in place, the
    new fp32 values returned; elementwise, so a shard's result is the
    whole leaf's slice, bit for bit."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g.square())
    delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    delta = delta + cfg.weight_decay * p32
    return p32 - lr * delta


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


def init_error_feedback(params: Any, *, mesh=None, specs: Any = None
                        ) -> Any:
    """fp32 zeros shaped like the params; over a mesh of several ranks
    this rank's ZeRO-1 shards (the reduced gradient's layout; ``specs``
    the model's ``param_specs``)."""
    if mesh is not None and mesh.size > 1:
        return zero1_plan(params, specs, mesh).zeros(
            next(tree_leaves(params)).device)
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


# ---------------------------------------------------------------------------
# ZeRO-1 over a mesh's "data" axis
# ---------------------------------------------------------------------------

#: the subtrees the reference stacks on a leading layer (group) axis, one
#: list entry a layer in the port (``repro_torch.bridge.PAGEABLE_GROUPS``)
STACKED_GROUPS = ("layers", "groups", "dec_layers", "enc_layers")


def opt_state_specs(param_specs: Any) -> dict:
    """The moments inherit the params' sharding (the reference's); the
    mesh step extends them by ZeRO-1 (:func:`zero1_specs`)."""
    return {"step": P(), "m": param_specs, "v": param_specs}


class Stacked(list):
    """A leaf of the reference's stacked tree: the port's per-layer
    leaves (or whatever stands for them), in layer order."""


def stacked_view(tree: Any) -> Any:
    """``tree`` (params, or any tree of their structure) in the
    reference's layout: each list of :data:`STACKED_GROUPS` becomes one
    dict of its entries' structure whose leaves are :class:`Stacked`."""
    def merge(entries):
        if isinstance(entries[0], dict):
            return {k: merge([e[k] for e in entries]) for k in entries[0]}
        return Stacked(entries)
    return {k: merge(v) if k in STACKED_GROUPS and isinstance(v, list)
            else v for k, v in tree.items()}


def _ref_leaves(view: Any):
    """The leaves of a :func:`stacked_view`, a :class:`Stacked` one leaf."""
    if isinstance(view, dict):
        for v in view.values():
            yield from _ref_leaves(v)
    elif isinstance(view, (list, tuple)) and not isinstance(view,
                                                            (Stacked, P)):
        for v in view:
            yield from _ref_leaves(v)
    else:
        yield view


def _ref_build(view: Any, values) -> Any:
    """The structure of ``view`` with its leaves taken from ``values`` in
    order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, Stacked):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(view)


def unstack_groups(tree: dict) -> dict:
    """A tree of the reference's stacked structure (moments gathered
    whole, say) -> the port's: each stacked group unstacked along its
    leading axis into a list of per-layer dicts, the rest as it is."""
    def count(node) -> int:
        return (count(next(iter(node.values()))) if isinstance(node, dict)
                else node.shape[0])

    def entry(node, i):
        if isinstance(node, dict):
            return {k: entry(v, i) for k, v in node.items()}
        return node[i]
    return {k: ([entry(v, i) for i in range(count(v))]
                if k in STACKED_GROUPS and isinstance(v, dict) else v)
            for k, v in tree.items()}


def stack_groups(tree: dict) -> dict:
    """The port's tree -> the reference's stacked structure: each list of
    :data:`STACKED_GROUPS` stacked leaf by leaf along a new leading axis
    (a copy); the inverse of :func:`unstack_groups`."""
    view = stacked_view(tree)
    return _ref_build(view, [torch.stack(list(x)) if isinstance(x, Stacked)
                             else x for x in _ref_leaves(view)])


class ZeroLeaf:
    """One leaf of the reference's stacked tree on this rank: the port's
    flat param leaves it stands for (``index``, one a layer when
    ``stacked``), its resolved ``spec``, this rank's ``shape`` (model
    shards applied; the layer axis leading when stacked), the dim ZeRO-1
    shards over ``"data"`` (``zero``, None without one) and this rank's
    moment ``shard`` shape."""

    def __init__(self, index: list[int], stacked: bool, spec: P,
                 shape: tuple[int, ...], data: int, model: int):
        self.index, self.stacked, self.shape = index, stacked, shape
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self.model_sharded = model > 1 and any(
            e == "model" or (isinstance(e, tuple) and "model" in e)
            for e in spec)
        self.zero = None
        if data > 1:
            for i, (dim, entry) in enumerate(zip(shape, spec)):
                if entry is None and dim % data == 0 and dim >= data:
                    self.zero = i
                    break
        self.spec = P(*("data" if i == self.zero else e
                        for i, e in enumerate(spec)))
        self.shard = tuple(d // data if i == self.zero else d
                           for i, d in enumerate(shape))


class ZeroPlan:
    """:func:`zero1_plan`'s result: the :class:`ZeroLeaf` of every leaf of
    the reference's stacked tree, in its order, and the tree's
    structure (``view``)."""

    def __init__(self, view: Any, leaves: list[ZeroLeaf], mesh):
        self.view, self.leaves, self.mesh = view, leaves, mesh

    def zeros(self, device, shape: str = "shard") -> Any:
        """fp32 zeros of each leaf's ``shard`` (or ``shape``), in the
        reference's stacked structure."""
        return _ref_build(self.view, [
            torch.zeros(getattr(leaf, shape), dtype=torch.float32,
                        device=device) for leaf in self.leaves])

    def specs(self) -> Any:
        """The ZeRO-1 spec tree (:func:`zero1_specs`)."""
        return _ref_build(self.view, [leaf.spec for leaf in self.leaves])

    def accumulators(self, device) -> list[torch.Tensor]:
        """fp32 zeros of each leaf's local (stacked) shape: the gradient
        sums a step accumulates into (:meth:`accumulate`)."""
        return [torch.zeros(leaf.shape, dtype=torch.float32, device=device)
                for leaf in self.leaves]

    def accumulate(self, accs: list[torch.Tensor], grads: list) -> None:
        """Add the port's flat gradient list (one a param leaf) into the
        stacked fp32 sums."""
        for leaf, acc in zip(self.leaves, accs):
            if leaf.stacked:
                for j, i in enumerate(leaf.index):
                    acc[j].add_(grads[i].float())
            else:
                acc.add_(grads[leaf.index[0]].float())


def zero1_plan(params: Any, specs: Any, mesh) -> ZeroPlan:
    """The reference's ZeRO-1 layout over the port's params: ``params``
    this rank's shards (the port's tree, layers a list), ``specs`` the
    model's ``param_specs`` (lists of per-layer specs), each fp32 moment
    of the stacked tree sharded over ``"data"`` on its first dim that is
    not model-sharded and that ``data`` divides (the reference dry run's
    ``zero1``)."""
    from repro_torch.runtime.sharding import _map_specs, resolve_spec
    flat = list(tree_leaves(params))
    counter = iter(range(len(flat)))
    view = stacked_view(tree_map(lambda _: next(counter), params))
    # the specs in the params' key order
    sview = stacked_view(_map_specs(lambda _, spec, __: spec, specs, params))
    data, model = mesh.axis_size("data"), mesh.axis_size("model")
    leaves = []
    for idx, spec in zip(_ref_leaves(view), _ref_leaves(sview)):
        stacked = isinstance(idx, Stacked)
        index = list(idx) if stacked else [idx]
        shape = tuple(flat[index[0]].shape)
        if stacked:
            shape, spec = (len(index),) + shape, P(None, *spec[0])
        leaves.append(ZeroLeaf(index, stacked, resolve_spec(spec, mesh),
                               shape, data, model))
    return ZeroPlan(_ref_build(view, [None] * len(leaves)), leaves, mesh)


def zero1_specs(params: Any, specs: Any, mesh) -> dict:
    """The spec tree of the ZeRO-1 moments (the reference's stacked
    structure, ``"data"`` on each leaf's ZeRO-1 dim), as
    ``opt_state_specs`` gives them for the step count."""
    return opt_state_specs(zero1_plan(params, specs, mesh).specs())


def _shard_of(leaf: ZeroLeaf, params: list, rank: int) -> torch.Tensor:
    """This rank's ZeRO-1 shard of the params a leaf stands for (a new
    tensor when stacked, a view otherwise)."""
    z = leaf.zero
    c = leaf.shard[z]
    if not leaf.stacked:
        return params[leaf.index[0]].narrow(z, rank * c, c)
    if z == 0:
        return torch.stack([params[i] for i in
                            leaf.index[rank * c:(rank + 1) * c]])
    return torch.stack([params[i].narrow(z - 1, rank * c, c)
                        for i in leaf.index])


@torch.no_grad()
def zero1_apply(cfg: AdamWConfig, params: Any, accs: list[torch.Tensor],
                state: dict, plan: ZeroPlan, err: Any = None) -> dict:
    """One ZeRO-1 AdamW step over ``plan.mesh`` from this rank's fp32
    gradient sums ``accs`` (:meth:`ZeroPlan.accumulators`, already the
    rank's mean over microbatches): each reduced over ``"data"`` in fp32
    (reduce-scatter onto the ZeRO-1 shard, else all-reduce), int8
    compressed with error feedback when ``err`` is given (one scale a
    whole leaf, from the absmax over every rank), clipped by the global
    norm (each element counted once: sharded leaves summed over their
    shards, replicated ones once), applied to this rank's shard, and the
    updated shards all-gathered over ``"data"`` into ``params`` (in
    place).  Returns ``{"grad_norm", "lr"}``; ``state`` is updated in
    place."""
    mesh = plan.mesh
    td, tm = mesh.transport("data"), mesh.transport("model")
    di, mi = mesh.axis_index("data"), mesh.axis_index("model")
    flat = list(tree_leaves(params))
    grads = [td.reduce_scatter(acc, leaf.zero) if leaf.zero is not None
             else td.all_reduce(acc) for leaf, acc in zip(plan.leaves, accs)]
    if err is not None:
        errs = list(_ref_leaves(err))
        totals = [g + e for g, e in zip(grads, errs)]
        amax = torch.stack([t.abs().max() for t in totals])
        amax = tm.all_gather(amax[None], 0).amax(0)
        amax = td.all_gather(amax[None], 0).amax(0)
        grads = []
        for t, e, a in zip(totals, errs, amax.unbind(0)):
            scale = (a + 1e-12) / 127.0
            deq = decompress_int8(_quantize(t, scale), scale)
            e.copy_(t - deq)
            grads.append(deq)
    # each element once: a leaf replicated over an axis counts on that
    # axis's rank 0 only
    parts = [g.square().sum() for leaf, g in zip(plan.leaves, grads)
             if (leaf.model_sharded or mi == 0)
             and (leaf.zero is not None or di == 0)]
    sq = (sum(parts) if parts
          else torch.zeros((), device=grads[0].device)).reshape(1)
    gnorm = torch.sqrt(td.all_reduce(tm.all_reduce(sq)))[0]
    step = state["step"] + 1
    lr = schedule_value(cfg, step)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    bc1, bc2 = _bias_corrections(cfg, step)
    for leaf, g, m, v in zip(plan.leaves, grads, _ref_leaves(state["m"]),
                             _ref_leaves(state["v"])):
        if leaf.zero is None:
            for j, i in enumerate(leaf.index):
                sel = (lambda t: t[j]) if leaf.stacked else (lambda t: t)
                p = flat[i]
                p.copy_(_adamw_leaf(cfg, p.float(), sel(g), sel(m), sel(v),
                                    scale, lr, bc1, bc2))
            continue
        p = _shard_of(leaf, flat, di)
        new = _adamw_leaf(cfg, p.float(), g, m, v, scale, lr, bc1,
                          bc2).to(p.dtype)
        full = td.all_gather(new, leaf.zero)
        if leaf.stacked:
            for j, i in enumerate(leaf.index):
                flat[i].copy_(full[j])
        else:
            flat[leaf.index[0]].copy_(full)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}

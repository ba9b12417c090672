"""The dry run: every (architecture x input shape x mesh) cell of the
port's own program, traced on fake tensors (counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles each cell with ``ShapeDtypeStruct``
inputs.  Here the port's prefill and decode steps
(:func:`repro_torch.runtime.serve.make_prefill_step`,
:func:`~repro_torch.runtime.serve.make_serve_step`) run at full width
and production shapes on fake tensors (no data, nothing allocated), as
rank 0 of the production mesh sees them (:func:`repro_torch.launch.mesh.
make_production_mesh`: the model bound row-parallel, as the reference
lowers with ``param_specs``; every collective through a shape-only
transport), under the cost model of :mod:`repro_torch.launch.op_cost`.
The card is stood in for by the ``meta`` device (a CPU-only build cannot
index a fake CUDA tensor), so the kernels' wrappers take their device
branch, meet fake inputs there and charge their cost without launching,
and no stream, event or synchronisation is made; the host tiers are fake
``cpu`` tensors.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40-cell sweep
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --paged

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>
[__paged][__kvq].json``, with the reference's tag and keys, per rank:

* ``memory``: ``argument_bytes`` (the rank's parameter shards, its cache
  shard and the step's inputs on the card, as the caching allocator
  rounds them), ``temp_bytes`` (the step's peak above them),
  ``peak_device_bytes``, ``host_argument_bytes`` (weights at rest in the
  remote tier under ``--paged``) and ``host_temp_bytes``; beside them
  ``params`` (the shards' bytes by tier, unpadded, the reference's shard
  shapes x itemsize) and ``cache_bytes``.
* ``cost``: ``flops``, ``bytes_accessed``, ``transcendentals``, and
  ``top_ops_by_bytes`` (the ATen ops that moved the most, with their
  flops and bytes: where a step's traffic comes from).
* ``collectives``: ``bytes`` and ``counts`` by kind, under the
  reference's names, and ``total_bytes``: the shape-only transports'
  tally (one count a transfer; bytes the payload this rank writes, where
  the reference's walker takes the larger of a collective's operand and
  result, N times the payload for an all-gather).

Keys left out, having no meaning here: ``output_bytes`` and
``alias_bytes`` (no buffer assignment: the outputs are temporaries alive
at the peak, and the cache is written in place), ``lower_s`` and
``compile_s`` (nothing is compiled; ``trace_s`` is the trace's time),
``xla_flops`` and ``xla_bytes_accessed`` (no XLA), and
``once_per_loop`` (loops run per iteration; see ``op_cost``, "Loops").

A ``train_4k`` cell traces the mesh's training step
(:func:`repro_torch.runtime.train.make_train_step` with the mesh: the
forward, the backward through the TAB's autograd boundaries, the
``"data"`` reductions and the ZeRO-1 update) on rank 0's shards: its
params, its ZeRO-1 moments (the reference's ``zero1`` rule) and its
``"data"`` shard of the batch (256 / 16 rows), with ``accum_steps`` 2
where ``d_model >= 5120``, as the reference sets it.  ``memory`` then
adds ``moment_bytes`` and ``grad_bytes`` (the rank's fp32 gradient sums,
part of the transient); the gradients, moments and params all count in
the peak.

Cells the port cannot trace yet are recorded with ``status:
"skipped"`` and the reason (:func:`skip_reason`), decided before any
tracing: the MoE configs' ``train_4k`` (expert-parallel training is not
ported) and ``train_4k`` under ``--paged`` (training over paged
weights), ``long_500k`` outside the sub-quadratic families (the
reference's own reason), and ``--paged`` for the grouped and
encoder-decoder families (the server's refusal of their tiers over a
mesh).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import prng
from repro_torch.configs import ARCH_IDS, SUBQUADRATIC, build_model, get_config
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import Mesh, P, make_production_mesh
from repro_torch.memory.accounting import tree_bytes, tree_leaves, tree_map
from repro_torch.runtime import optim, sharding, train
from repro_torch.runtime.serve import (make_prefill_step, make_serve_step,
                                       mesh_pager_refusal)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

#: the card's stand-in in a dry run
DEVICE = torch.device("meta")

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

#: why the MoE configs' and ``--paged`` train cells are skipped
TRAIN_MOE_REASON = train.MOE_MESH_REASON
TRAIN_PAGED_REASON = train.PAGED_REASON
LONG_REASON = ("full quadratic attention at 512k context "
               "(DESIGN.md long_500k policy)")

#: the transports' kinds under the reference's collective names
COLLECTIVE_NAMES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
                    "reduce_scatter": "reduce-scatter",
                    "all_to_all": "all-to-all",
                    "ppermute": "collective-permute"}


def _fit_spec(spec: P, shape, mesh: Mesh) -> P:
    """Drop axis entries that don't divide the dim (e.g. batch=1 cells),
    the reference's rule."""
    out = []
    for i, entry in enumerate(tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for n in names:
            total *= mesh.axis_size(n)
        out.append(entry if shape[i] % total == 0 and shape[i] >= total
                   else None)
    return P(*out)


def shard_shape(shape, spec: P, mesh: Mesh) -> tuple[int, ...]:
    """This rank's shape of a ``shape`` leaf under ``spec`` over ``mesh``
    (resolved and fitted as the reference's ``sds``)."""
    spec = _fit_spec(sharding.resolve_spec(spec, mesh), shape, mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        for n in names:
            out[i] //= mesh.axis_size(n)
    return tuple(out)


def skip_reason(arch: str, shape_name: str, *, paged: bool = False,
                kv_quant: bool = False) -> str | None:
    """Why the port cannot trace this cell over the production mesh
    (None when it can), decided before any tracing."""
    if shape_name == "long_500k" and arch not in SUBQUADRATIC:
        return LONG_REASON
    cfg = get_config(arch)
    if paged:
        cfg = cfg.with_pager(enabled=True, lookahead=1)
    model = build_model(cfg)
    if SHAPES[shape_name]["kind"] == "train":
        return train.mesh_train_refusal(model)
    return mesh_pager_refusal(model)


def train_accum_steps(cfg) -> int:
    """The reference's microbatching of a ``train_4k`` cell: 2 where
    ``d_model >= 5120`` (per-microbatch activations fit HBM), else 1."""
    return 2 if cfg.d_model >= 5120 else 1


def _one_rank(mesh: Mesh | None) -> bool:
    return mesh is None or mesh.size == 1


def _place_params(model, params: dict, mesh: Mesh | None) -> dict:
    """The rank's parameters: the whole tree on one device, the rank's
    shards over a mesh (``place_params`` by ``param_specs``); with the
    pager on, the pageable group at rest in the remote tier."""
    mem = model.mem
    if _one_rank(mesh):
        if mem.config.enabled:
            for k in sharding.PAGEABLE_GROUPS:
                if k in params:
                    params[k] = mem.place_layer_weights(params[k])
        return params
    return mem.place_params(params, model.param_specs())


def fake_mode() -> FakeTensorMode:
    """A fake mode for a dry run, without the op cache (hashing the
    arguments of a 2048-way ``cat`` costs more than the op)."""
    fake = FakeTensorMode()
    fake.cache_enabled = False
    return fake


def make_inputs(model, kind: str, batch: int, seq: int,
                mesh: Mesh | None = None) -> dict:
    """The inputs of one ``kind`` step ("prefill", "decode" or "train")
    of ``model`` as the rank of ``mesh`` holds them (one device without
    one), as fake tensors on :data:`DEVICE`: call it inside a
    ``FakeTensorMode``.  ``batch`` is the global batch, split over the
    batch axes by the reference's ``_fit_spec`` rule; the cache holds
    ``seq`` positions a slot (the reference's ``abstract_cache``), the
    rank's KV heads.  Binds ``model`` to ``mesh`` row-parallel (the
    reference lowers with ``param_specs``).  Returns ``{"kind", "params",
    "cache", "tokens", "cur_pos", "key", "extra"}``; a train step's
    ``{"kind", "params", "opt", "batch"}`` (``seq`` its tokens a row:
    the rank's batch rows, its ZeRO-1 moments over a mesh)."""
    cfg = model.cfg
    mesh = mesh if mesh is not None else Mesh({"data": 1, "model": 1})
    # the cache's full shapes before the bind (which shards the KV heads)
    full_cache = model.cache_shapes(batch, seq) if kind != "train" else None
    bspec = sharding.batch_spec(mesh)
    full = tree_map(lambda x: x.to(DEVICE), model.init(0, device="cpu"))
    if not _one_rank(mesh):
        model.mem.bind_mesh(mesh, row_parallel=True)
    params = _place_params(model, full, mesh)
    del full
    if kind == "train":
        return _train_inputs(model, params, batch, seq, mesh)
    cache = sharding._map_specs(
        lambda _, spec, leaf: torch.zeros(shard_shape(leaf[0], spec, mesh),
                                          dtype=leaf[1], device=DEVICE),
        model.cache_specs(), full_cache)
    b = shard_shape((batch,), P(bspec[0]), mesh)[0]
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                      device=DEVICE)
    if cfg.family == "vlm" and kind == "prefill":
        extra["patches"] = torch.zeros((b, cfg.num_patches, cfg.d_model),
                                       device=DEVICE)
    if kind == "prefill":
        text = seq - cfg.num_patches if cfg.family == "vlm" else seq
        return dict(kind=kind, params=params, cache=cache, extra=extra,
                    tokens=torch.zeros((b, text), dtype=torch.int64,
                                       device=DEVICE))
    if kind != "decode":
        raise ValueError(f"step kind {kind!r}: 'prefill' or 'decode'")
    return dict(kind=kind, params=params, cache=cache, extra=extra,
                tokens=torch.zeros((b, 1), dtype=torch.int64, device=DEVICE),
                cur_pos=torch.zeros((b,), dtype=torch.int32, device=DEVICE),
                key=prng.PRNGKey(0, DEVICE))


def _train_inputs(model, params: dict, batch: int, seq: int,
                  mesh: Mesh) -> dict:
    """A train step's inputs (:func:`make_inputs`): the rank's params,
    its moments (ZeRO-1 shards over a mesh), its rows of the batch."""
    cfg = model.cfg
    b = shard_shape((batch,), P(sharding.batch_spec(mesh)[0]), mesh)[0]
    text = seq - cfg.num_patches if cfg.family == "vlm" else seq
    rows = {"tokens": torch.zeros((b, text), dtype=torch.int32,
                                  device=DEVICE),
            "labels": torch.zeros((b, text), dtype=torch.int32,
                                  device=DEVICE)}
    if cfg.family == "encdec":
        rows["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                     device=DEVICE)
    if cfg.family == "vlm":
        rows["patches"] = torch.zeros((b, cfg.num_patches, cfg.d_model),
                                      device=DEVICE)
    opt = optim.init_opt_state(params, mesh=mesh, specs=model.param_specs())
    return dict(kind="train", params=params, opt=opt, batch=rows)


def input_specs(arch: str, shape_name: str, mesh: Mesh, *,
                paged: bool = False, kv_quant: bool = False,
                fake: FakeTensorMode | None = None):
    """``(model, cfg, inputs)`` of a cell (the reference's
    ``input_specs``): :func:`make_inputs` at the shape's batch and
    sequence inside ``fake`` (a new ``FakeTensorMode`` when None; the
    inputs carry it)."""
    cfg = get_config(arch)
    if paged:
        cfg = cfg.with_pager(enabled=True, lookahead=1)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    model = build_model(cfg)
    info = SHAPES[shape_name]
    with fake or fake_mode():
        inputs = make_inputs(model, info["kind"], info["batch"], info["seq"],
                             mesh)
    return model, cfg, inputs


def _arguments(model, inputs: dict) -> list[torch.Tensor]:
    """The tensors alive before the step, in the order they were made:
    the parameters (at rest and local), the prefetcher's and the KV
    window's device buffers, the cache, the step's inputs."""
    mem = model.mem
    out = list(tree_leaves(inputs["params"]))
    if inputs["kind"] == "train":
        return (out + list(tree_leaves(inputs["opt"]))
                + list(tree_leaves(inputs["batch"])))
    if mem.prefetcher is not None:
        out += mem.prefetcher.window
    if mem.kv_window is not None:
        out += [x for w in mem.kv_window.window for x in tree_leaves(w)]
    out += list(tree_leaves(inputs["cache"]))
    out += list(tree_leaves(inputs["extra"]))
    out += [inputs[k] for k in ("tokens", "cur_pos", "key") if k in inputs]
    return out


def _by_tier(tree) -> dict[str, int]:
    """Leaf bytes of ``tree`` by where they live (device / host)."""
    out = {"device": 0, "host": 0}
    for x in tree_leaves(tree):
        cls = "device" if x.device.type in op_cost.DEVICE_TYPES else "host"
        out[cls] += x.numel() * x.element_size()
    return out


def trace(model, inputs: dict, mesh: Mesh | None = None, *,
          accum_steps: int = 1) -> dict:
    """Run one step of ``inputs["kind"]`` on the fake ``inputs``
    (:func:`make_inputs`) under the cost model; returns ``memory``,
    ``cost``, ``collectives`` and ``ops`` (the ATen ops traced) for one
    rank.  A train step takes ``accum_steps`` microbatches."""
    fake = next(iter(tree_leaves(inputs["batch" if inputs["kind"] == "train"
                                        else "cache"]))).fake_mode
    transports = {} if mesh is None else mesh.transports()
    for t in transports.values():
        t.reset_tally()
    cost = op_cost.OpCost()
    t0 = time.perf_counter()
    training = inputs["kind"] == "train"
    with fake, torch.set_grad_enabled(training), cost:
        args = cost.track(_arguments(model, inputs))
        if training:
            step = train.make_train_step(model, train.TrainConfig(
                accum_steps=accum_steps), mesh)
            out = step(inputs["params"], inputs["opt"], inputs["batch"])
        elif inputs["kind"] == "prefill":
            out = make_prefill_step(model)(inputs["params"],
                                           inputs["tokens"], inputs["cache"],
                                           inputs["extra"] or None)
        else:
            out = make_serve_step(model)(inputs["params"], inputs["tokens"],
                                         inputs["cache"], inputs["cur_pos"],
                                         inputs["key"])
        del out
    cost.close()
    coll_bytes, coll_counts = {}, {}
    for t in transports.values():
        for kind, tal in t.tally.items():
            if tal["transfers"]:
                name = COLLECTIVE_NAMES[kind]
                coll_bytes[name] = coll_bytes.get(name, 0.0) + tal["bytes"]
                coll_counts[name] = (coll_counts.get(name, 0)
                                     + tal["transfers"])
    params = _by_tier(inputs["params"])
    memory = {
        "argument_bytes": args["device"],
        "temp_bytes": cost.device_peak - args["device"],
        "peak_device_bytes": cost.device_peak,
        "host_argument_bytes": args["host"],
        "host_temp_bytes": cost.host_peak - args["host"],
        "params": params}
    if training:
        memory["moment_bytes"] = tree_bytes(inputs["opt"])
        # the fp32 gradient sums: the params' local shapes in fp32
        memory["grad_bytes"] = 4 * sum(x.numel() for x in
                                       tree_leaves(inputs["params"]))
        memory["batch_bytes"] = tree_bytes(inputs["batch"])
    else:
        memory["cache_bytes"] = tree_bytes(inputs["cache"])
    return {
        "trace_s": round(time.perf_counter() - t0, 2),
        "ops": cost.ops,
        "memory": memory,
        "cost": cost.result(),
        "collectives": {"bytes": coll_bytes, "counts": coll_counts,
                        "total_bytes": float(sum(coll_bytes.values()))},
    }


def trace_step(model, kind: str, batch: int, seq: int,
               mesh: Mesh | None = None, *, accum_steps: int = 1) -> dict:
    """One ``kind`` step of ``model`` ("prefill", "decode" or "train") at
    a global ``batch`` and a cache (or rows) of ``seq`` positions, traced
    as the rank of ``mesh`` runs it (one device without one):
    :func:`make_inputs` then :func:`trace` (``run_cell`` traces a cell
    so); what the card's own allocator is held to (``chip_smoke.py``).
    A train step takes ``accum_steps`` microbatches."""
    fake = fake_mode()
    try:
        with fake:
            inputs = make_inputs(model, kind, batch, seq, mesh)
        return trace(model, inputs, mesh, accum_steps=accum_steps)
    finally:
        if not _one_rank(mesh):
            model.mem.bind_mesh(None)


def cell_tag(arch: str, shape_name: str, *, multi_pod: bool = False,
             paged: bool = False, kv_quant: bool = False) -> str:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    return (f"{arch}__{shape_name}__{mesh_name}" + ("__paged" if paged else "")
            + ("__kvq" if kv_quant else ""))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             paged: bool = False, kv_quant: bool = False,
             save: bool = True) -> dict:
    """Trace one cell on rank 0 of the production mesh (or record why it
    is skipped) and save its JSON."""
    tag = cell_tag(arch, shape_name, multi_pod=multi_pod, paged=paged,
                   kv_quant=kv_quant)
    reason = skip_reason(arch, shape_name, paged=paged, kv_quant=kv_quant)
    if reason is not None:
        result = {"cell": tag, "status": "skipped", "reason": reason}
        if save:
            _save(tag, result)
        return result
    mesh = make_production_mesh(multi_pod=multi_pod)
    model, cfg, inputs = input_specs(arch, shape_name, mesh, paged=paged,
                                     kv_quant=kv_quant)
    try:
        traced = trace(model, inputs, mesh,
                       accum_steps=train_accum_steps(cfg))
    finally:
        model.mem.bind_mesh(None)
    result = {"cell": tag, "status": "ok", "arch": arch, "shape": shape_name,
              "mesh": "pod2x16x16" if multi_pod else "pod16x16",
              "paged": paged, "kv_quant": kv_quant, "devices": mesh.size,
              **traced}
    if save:
        _save(tag, result)
    return result


def _save(tag: str, result: dict) -> None:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    (RESULTS_DIR / f"{tag}.json").write_text(json.dumps(result, indent=1))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="FengHuang configuration: weights in the remote "
                         "tier, paged per layer")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (dense family)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    failures = 0
    for arch, shape, mp in cells:
        tag = cell_tag(arch, shape, multi_pod=mp, paged=args.paged,
                       kv_quant=args.kv_quant)
        if args.skip_existing and (RESULTS_DIR / f"{tag}.json").exists():
            prev = json.loads((RESULTS_DIR / f"{tag}.json").read_text())
            if prev.get("status") in ("ok", "skipped"):
                print(f"[skip] {tag} (cached {prev['status']})")
                continue
        try:
            r = run_cell(arch, shape, multi_pod=mp, paged=args.paged,
                         kv_quant=args.kv_quant)
            if r["status"] == "ok":
                peak = r["memory"]["peak_device_bytes"] / 2**30
                print(f"[ok]   {tag}: peak {peak:.2f} GiB/dev, "
                      f"flops {r['cost']['flops']:.3e}, "
                      f"coll {r['collectives']['total_bytes']:.3e} B, "
                      f"trace {r['trace_s']:.1f}s")
            else:
                print(f"[skip] {tag}: {r['reason']}")
        except Exception as e:  # noqa: BLE001
            failures += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:400]}")
            _save(tag, {"cell": tag, "status": "failed",
                        "error": f"{type(e).__name__}: {str(e)[:2000]}",
                        "traceback": traceback.format_exc()[-4000:]})
    print(f"done: {len(cells) - failures}/{len(cells)} cells passed")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

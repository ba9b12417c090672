"""The fused decode block as one CUDA graph: the counterpart of the
reference's jitted, donated ``lax.scan`` of ``block_size`` decode steps
(``repro.runtime.serve.make_decode_loop`` over ``memory.donating_jit``).
:func:`repro_torch.runtime.serve.make_decode_loop` builds a
:class:`DecodeLoop` from here.

* **Donation means in place.**  A block writes the pools or the slab in
  place (the models' ``_write_tokens``, ``_decode_scatter``) and ends by
  copying its final ``tokens``, ``pos``, ``active`` and ``remaining``
  into the :class:`~repro_torch.models.base.DecodeState` it was given, so
  the cache and the state a caller passes are the ones it gets back, and
  every block reads its inputs from the same buffers.
* **Two routes, chosen once** (:func:`choose_route`): ``graph`` on a CUDA
  device with the weights and the KV resident -- over a mesh too, when
  its collectives stay on the device (the shared region's flags notice)
  --, ``eager`` otherwise.  The
  eager route issues every op from the host (the plain loop, the CPU's
  only route).  Weights paged from the remote tier, ``offload_kv`` and
  MoE expert paging stay eager: their copy stream's events and their
  per-layer host counters (the Tensor Prefetcher's fetches, the expert
  gather's) are not captured.  A route is never a fallback from the
  other.
* **Keys, warm-up, capture, replay** (:class:`DecodeBlocks`).  A graph is
  keyed by the identity of its inputs: the address, shape, stride and
  dtype of every tensor of ``params``, ``cache`` and ``state``.  The
  first block of a key runs eagerly (the warm-up a capture needs, its
  results used); the second is captured and replayed, and every later
  one replays.  A key seen once never pays for a capture.  The graphs of
  one loop share one memory pool: they replay one at a time on one
  stream.  Their outputs live in that pool until the next replay of the
  same graph, which a caller's device-to-host copy, issued in stream
  order after the block, never races.
* **Launch counts.**  A replay runs the captured kernels again without
  their Python wrappers, so launches made while a capture is open go
  into its tally (:func:`repro_torch.kernels.build.launch_tally`) and each
  replay adds the tally to the counts: K1 once a layer a step, replayed
  or not.  The split counters K1 shares (``build.counters``) are sized
  before a capture; growing them inside one raises.
* **Over a mesh** each rank captures its own graph.  A capture runs no
  kernel, so no rank waits on a peer while capturing; the collectives'
  sequence numbers live on the device (the flag area), so a replay stays
  in step with the eager collectives of the admissions and the votes,
  and a key's first block runs eagerly on every rank in lockstep.
* **Nothing in a block waits for the host**: no ``.item()``, no
  ``bool()`` of a tensor, no ``nonzero`` or boolean-mask indexing, no
  tensor made from host data, no shape that depends on data.  A capture
  that meets one fails with a CUDA error, which is raised.  Python's
  cyclic garbage collector is off while a capture is open: collecting
  an earlier server's graphs there would free their memory mid-capture,
  which invalidates it.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

import torch

from repro_torch.kernels import build
from repro_torch.memory import tiers
from repro_torch.models.base import DecodeState
from repro_torch.models.transformer import decode_loop

GRAPH, EAGER = "graph", "eager"

#: (tensor class, what paging it means): a class the orchestrator places
#: outside local memory keeps the decode block eager
_PAGED = (("layer_weights", "weights paged from the remote tier"),
          ("kv_pool", "offload_kv"),
          ("expert_weights", "expert paging"))

#: the state fields a block advances (``pages`` and ``slot_keys`` it reads)
_ADVANCED = ("tokens", "pos", "active", "remaining")


def paged_classes(model) -> list[str]:
    """The tensor classes ``model``'s orchestrator's policies place
    outside local memory, each as what its paging means (the policy
    matrix is the placement plan; a fault at placement resets the class
    to local residency)."""
    policies = model.mem.policies
    return [why for cls, why in _PAGED
            if cls in policies and policies[cls].tier != tiers.LOCAL]


def eager_reasons(model) -> list[str]:
    """Why ``model``'s decode block cannot be captured: the paged classes
    (:func:`paged_classes`), and a mesh of several ranks whose
    collectives wait on the host (a process group, or a shared region
    under the barrier notice: a graph cannot hold a host wait) or that
    has no transport (abstract).  A shared region under the flags notice
    keeps the whole collective on the device, so its mesh is captured as
    one card is."""
    reasons = paged_classes(model)
    mesh = model.mem.mesh
    if model.mem.model_shards > 1:
        waits = sorted(f"{axis}: {type(t).__name__}"
                       + (f" notice={t.notice}" if hasattr(t, "notice")
                          else "")
                       for axis, t in mesh.transports().items()
                       if not t.capturable)
        if waits or not mesh.bound:
            reasons.append(f"a mesh whose collectives wait on the host "
                           f"({', '.join(waits) or 'no transport'})")
    return reasons


def choose_route(model, device, graph: bool | None = None
                 ) -> tuple[str, str]:
    """``(route, why)`` for ``model`` decoding on ``device``: ``graph``
    with weights and KV resident on a CUDA device, ``eager`` otherwise.
    ``graph=False`` asks for the eager route; ``graph=True`` for the
    graph, and raises ``ValueError`` where it cannot run (on the CPU,
    under paging)."""
    device = torch.device(device)
    if device.type != "cuda":
        if graph:
            raise ValueError(f"the graph route needs a CUDA device, not "
                             f"{device}")
        return EAGER, f"plain PyTorch on {device}"
    if graph is False:
        return EAGER, "asked for (graph=False)"
    reasons = eager_reasons(model)
    if reasons and graph:
        raise ValueError(f"the graph route needs the weights and the KV "
                         f"resident: {', '.join(reasons)}")
    if reasons:
        return EAGER, ", ".join(reasons)
    return GRAPH, "weights and KV resident on the card"


def block_key(*trees) -> tuple:
    """The identity of a block's inputs: (address, shape, stride, dtype)
    of every tensor of the nested dicts, lists, tuples and decode states
    in ``trees``, in order; None as itself.  Any other leaf (paged
    weights, a window) raises ``TypeError``."""
    out: list = []

    def walk(x) -> None:
        if isinstance(x, torch.Tensor):
            out.append((x.data_ptr(), tuple(x.shape), x.stride(), x.dtype))
        elif type(x) is dict:
            for k, v in x.items():
                out.append(k)
                walk(v)
        elif type(x) in (list, tuple):
            out.append(len(x))
            for v in x:
                walk(v)
        elif isinstance(x, DecodeState):
            for name in ("tokens", "pos", "active", "remaining", "pages",
                         "slot_keys"):
                walk(getattr(x, name))
        elif x is None:
            out.append(x)
        else:
            raise TypeError(f"a decode graph cannot key a "
                            f"{type(x).__name__} leaf: the graph route "
                            f"takes tensors resident on the card")
    for t in trees:
        walk(t)
    return tuple(out)


class CudaGraphCapture:
    """Capture a block into a ``torch.cuda.CUDAGraph``.  Every graph of
    one owner allocates from one memory pool (``graph_pool_handle``):
    they replay one at a time on one stream.  ``pool_bytes`` sums what
    the captures reserved from the caching allocator for it."""

    def __init__(self):
        self.pool = None
        self.pool_bytes = 0

    def __call__(self, fn: Callable[[], tuple]) -> Callable[[], tuple]:
        """Capture ``fn()`` (not run: the first replay runs it); returns
        the replay, which gives the captured outputs."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self.pool):
            before = torch.cuda.memory_reserved()
            outs = fn()
            self.pool_bytes += torch.cuda.memory_reserved() - before

        def replay() -> tuple:
            g.replay()
            return outs
        return replay


class DecodeBlocks:
    """``block_size`` decode steps a call over inputs updated in place,
    on the ``graph`` or the ``eager`` route (module docstring).

    Counts: ``captures`` (graphs captured; the server's
    ``stats["compiles"]``) and their wall ``capture_seconds``;
    ``replays`` (blocks run as a graph) and ``eager`` (blocks run op by
    op: every block of the eager route, a key's first on the graph
    route); ``replayed``, kernel name -> the launches its replays made.
    ``capture`` is the capture backend, a :class:`CudaGraphCapture` on
    the graph route by default."""

    def __init__(self, model, *, block_size: int, temperature: float,
                 eos_id: int | None, route: str, capture=None):
        if route not in (GRAPH, EAGER):
            raise ValueError(f"unknown decode route {route!r}")
        self.model = model
        self.block_size = block_size
        self.temperature = temperature
        self.eos_id = eos_id
        self.route = route
        self.capture = (capture if capture is not None or route == EAGER
                        else CudaGraphCapture())
        # key -> (replay, its launch tally); no entry refers back here
        self.graphs: dict[tuple, tuple] = {}
        self.seen: set[tuple] = set()
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.eager = 0
        self.replayed: dict[str, int] = {}

    @property
    def pool_bytes(self) -> int:
        """Bytes the captures reserved for their shared memory pool."""
        return getattr(self.capture, "pool_bytes", 0)

    def block(self, params: dict, cache: dict, state: DecodeState
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One block op by op: ``(tokens, valid, nonfinite)``, each (B,
        block_size); the state's advanced fields copied back in place."""
        toks, valid, bad, st = decode_loop(
            self.model, params, cache, state, num_steps=self.block_size,
            temperature=self.temperature, eos_id=self.eos_id)
        for name in _ADVANCED:
            getattr(state, name).copy_(getattr(st, name))
        return toks, valid, bad

    def __call__(self, params: dict, cache: dict, state: DecodeState
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.route == EAGER:
            self.eager += 1
            return self.block(params, cache, state)
        key = block_key(params, cache, state)
        graph = self.graphs.get(key)
        if graph is None:
            if key not in self.seen:
                self.seen.add(key)
                self.eager += 1
                return self.block(params, cache, state)
            graph = self.graphs[key] = self._capture(params, cache, state)
        replay, tally = graph
        outs = replay()
        tally.replay()
        for (counter, _), n in tally.launches.items():
            self.replayed[counter.name] = self.replayed.get(counter.name,
                                                            0) + n
        self.replays += 1
        return outs

    def _capture(self, params: dict, cache: dict, state: DecodeState
                 ) -> tuple[Callable[[], tuple], build.LaunchTally]:
        """Capture a block: its replay, and the launches it makes."""
        cfg = self.model.cfg
        build.counters(state.pos.device,
                       state.pos.shape[0] * cfg.padded_kv_heads)
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with build.launch_tally() as tally:
                replay = self.capture(
                    lambda: self.block(params, cache, state))
        finally:
            if collecting:
                gc.enable()
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        return replay, tally


def apply_delta(pages: torch.Tensor, delta) -> None:
    """Scatter a ``(slots, cols, pids)`` page-table delta into ``pages``
    (B, W) in place, with one scatter: entries whose slot or column lies
    outside the table (padding carries an out-of-range column) are
    dropped and negative indices count from the end, as the reference's
    ``.at[slots, cols].set(pids)`` does.  Give device tensors: a host
    array is copied with a wait."""
    b, w = pages.shape
    slots, cols, pids = (torch.as_tensor(d, device=pages.device).long()
                         for d in delta)
    slots = torch.where(slots < 0, slots + b, slots)
    cols = torch.where(cols < 0, cols + w, cols)
    keep = (slots >= 0) & (slots < b) & (cols >= 0) & (cols < w)
    flat = torch.cat([pages.reshape(-1), pages.new_zeros(1)])
    flat.index_put_((torch.where(keep, slots * w + cols, b * w),),
                    pids.to(pages.dtype))
    pages.copy_(flat[:-1].view(b, w))


class DecodeLoop:
    """``loop(params, cache, state, delta=None)`` of
    :func:`repro_torch.runtime.serve.make_decode_loop`: the reference's
    return layouts, ``(tokens, valid, cache, state)`` or, with
    ``detect_nonfinite``, ``(tokens, valid, poison, cache, state)``.

    With ``donate`` (the default) the cache and the state passed are
    updated in place and returned; the route is chosen at the first call
    from the state's device (:func:`choose_route`, ``graph`` as there;
    ``blocks`` is None before).  Without, the block runs
    op by op into a new state (the input state, its page table included,
    is left as it was; the pools or the slab are written in place all
    the same: the port's models write them so).  On the graph route the
    returned tokens, valid and poison are the graph's own buffers, which
    its next replay overwrites: copy what is kept."""

    def __init__(self, model, *, block_size: int, temperature: float = 0.0,
                 eos_id: int | None = None, donate: bool = True,
                 detect_nonfinite: bool = False, graph: bool | None = None):
        if graph and not donate:
            raise ValueError("the graph route updates its inputs in place: "
                             "it needs donate=True")
        self.model = model
        self.block_size = block_size
        self.temperature = temperature
        self.eos_id = eos_id
        self.donate = donate
        self.detect_nonfinite = detect_nonfinite
        self.graph = graph
        self.blocks: DecodeBlocks | None = None

    def __call__(self, params: dict, cache: dict, state: DecodeState,
                 delta=None) -> tuple:
        if delta is not None and state.pages is not None:
            if not self.donate:
                state = dataclasses.replace(state,
                                            pages=state.pages.clone())
            apply_delta(state.pages, delta)
        if self.donate:
            if self.blocks is None:
                route, _ = choose_route(self.model, state.pos.device,
                                        self.graph)
                self.blocks = DecodeBlocks(
                    self.model, block_size=self.block_size,
                    temperature=self.temperature, eos_id=self.eos_id,
                    route=route)
            toks, valid, bad = self.blocks(params, cache, state)
        else:
            toks, valid, bad, state = decode_loop(
                self.model, params, cache, state, num_steps=self.block_size,
                temperature=self.temperature, eos_id=self.eos_id)
        out = (toks, valid, bad) if self.detect_nonfinite else (toks, valid)
        return out + (cache, state)

"""The flash attention wrapper: (B, S, H, d) API with GQA, for the model's
prefill and training.  CPU tensors take the plain blocked online-softmax
(differentiated by autograd), CUDA tensors the hand-written kernel; there
is no fallback from one to the other.

K2 launches through ctypes, so its output carries no autograd graph.
When grad is enabled and an input requires it, the launch runs inside
:class:`Attention`, whose backward is the plain
:func:`backward.flash_attention_bwd`; otherwise (serving, under ``no_grad``)
the kernel is called as it is."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref
from repro_torch.kernels.flash_attention.backward import flash_attention_bwd


class Attention(torch.autograd.Function):
    """K2's forward under autograd: the forward is one K2 launch, the
    backward :func:`backward.flash_attention_bwd` from the saved q, k and
    v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_valid):
        if isinstance(q, FakeTensor):      # a dry run's training step
            o = _shape_only(q, k, v, causal=causal, q_offset=q_offset,
                            kv_valid=kv_valid)
        else:
            o = _kernel.flash_attention(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        kv_valid=kv_valid)
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset,
                        kv_valid=kv_valid)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do, **ctx.mask)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              q_offset: int | None = None,
              kv_valid: int | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, d); k, v: (B, Sk, Hkv, d), Hq % Hkv == 0.  Query row
    i sits at position ``q_offset + i`` (default Sk - Sq, the suffix of
    the keys); keys at or past ``kv_valid`` (default Sk) never attend."""
    sq, sk = q.shape[1], k.shape[1]
    q_offset = sk - sq if q_offset is None else q_offset
    kv_valid = sk if kv_valid is None else kv_valid
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, kv_valid=kv_valid)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return Attention.apply(q, k, v, causal, window, q_offset, kv_valid)
    if isinstance(q, FakeTensor):
        return _shape_only(q, k, v, causal=causal, q_offset=q_offset,
                           kv_valid=kv_valid)
    return _kernel.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_valid=kv_valid)


def _shape_only(q, k, v, *, causal: bool, q_offset: int,
                kv_valid: int) -> torch.Tensor:
    """K2 in a shape-only run: its output, unlaunched, and its cost
    charged to the cost model (the plain version's products; the
    kernel's bytes: q, k and v read once, the output written once)."""
    from repro_torch.launch import op_cost
    b, sq, hq, d = q.shape
    flops, trans = _ref.flash_attention_cost(
        b, sq, hq, k.shape[1], d, causal=causal, q_offset=q_offset,
        kv_valid=kv_valid)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    op_cost.charge(flops=flops, transcendentals=trans,
                   nbytes=sum(t.numel() * t.element_size()
                              for t in (q, k, v, out)))
    return out

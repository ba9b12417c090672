"""The flash prefill wrapper: (B, S, H, d) API with GQA, for the model's
prefill.  CPU tensors take the plain blocked online-softmax, CUDA tensors
the hand-written kernel; there is no fallback from one to the other."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


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
    return _kernel.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_valid=kv_valid)

"""LLaVA-NeXT-style VLM backbone (llava-next-34b), counterpart of
``repro.models.vlm``.

The vision tower is a stub, as in the reference: the caller passes
precomputed patch embeddings ``extra={"patches": (B, num_patches,
d_model)}`` to :meth:`DenseLM.prefill_paged`, which prepends them to the
token embeddings at positions 0..P-1, the way projected CLIP patches
enter the language model in LLaVA.  Decode steps are text continuation;
everything else (GQA attention, SwiGLU MLP, paging) is the dense LM.
The server stays text-only, as the reference's: ``submit`` takes no
patches.
"""
from __future__ import annotations

from repro_torch.models.transformer import DenseLM


class VLM(DenseLM):
    """DenseLM consuming ``extra={'patches': (B, P, d)}`` at prefill;
    decode steps are pure text continuation."""

    def text_len(self, total_seq: int) -> int:
        """Text tokens for a given total sequence budget."""
        return max(1, total_seq - self.cfg.num_patches)

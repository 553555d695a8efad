"""VLM language backbone (InternVL2-76B family, arXiv:2404.16821; port of
``repro/models/vlm.py``).

The InternViT vision encoder and MLP projector are a stub, as in the
reference: the caller supplies projected patch embeddings [B, num_patches,
d_model].  The backbone is the InternLM2-style dense decoder; the patches
form a bidirectional prefix (the flash kernels' prefix mode), and the text
is causal over both.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import Cache, TransformerLM


class VLMModel(TransformerLM):
    """TransformerLM that consumes a patch-embedding prefix."""

    def forward(self, batch: Dict[str, torch.Tensor], remat: bool = False,
                return_hidden: bool = False,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``TransformerLM.forward`` with ``batch["patch_embeds"]`` (if
        any) as the prefix; the ``prefix_embeds`` argument is ignored, as
        in the reference."""
        return super().forward(batch, remat, return_hidden,
                               prefix_embeds=batch.get("patch_embeds"))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                max_seq: Optional[int] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                **kw) -> Tuple[torch.Tensor, Cache]:
        return super().prefill(tokens, lengths, max_seq,
                               prefix_embeds=patch_embeds)

    # decode_step, prefill_extend and the paged layout are inherited: the
    # patches live in the KV cache already.

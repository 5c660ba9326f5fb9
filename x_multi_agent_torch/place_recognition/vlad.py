"""Binary VLAD descriptors (port of ``x_multi_agent_tpu.place_recognition.vlad``).

compute_vlad: per descriptor, the nearest vocabulary word; the residual is
descriptor XOR word centroid; residuals are OR-aggregated per word into a
(W, 32) uint8 matrix. Torch has no bitwise-OR reduction (and a max of bytes
is not their OR), so the reduction runs over unpacked bits, where OR is
``any``, and packs after. vlad_score: normalized Hamming similarity.
"""
from __future__ import annotations

import torch

from .descriptors import pack_bits, popcount_table, unpack_bits
from .vocabulary import transform


def compute_vlad(
    words: torch.Tensor,  # (W, 32) uint8
    descriptors: torch.Tensor,  # (..., N, 32) uint8
    valid: torch.Tensor,  # (..., N)
) -> torch.Tensor:
    """-> (..., W, 32) uint8 VLAD."""
    w = words.shape[0]
    ids = transform(words, descriptors).long()  # (..., N)
    resid = torch.bitwise_xor(descriptors, words[ids])
    member = (ids[..., None] == torch.arange(w, device=ids.device)) & valid[..., None]
    bits = unpack_bits(resid)  # (..., N, 256)
    agg = torch.any(member[..., :, :, None] & bits[..., :, None, :], dim=-3)  # (..., W, 256)
    return pack_bits(agg)


def vlad_score(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Normalized Hamming similarity in [0, 1] of (..., W, 32) VLADs, float32."""
    v_length = x.shape[-2] * x.shape[-1] * 8
    ham = torch.sum(popcount_table(x.device)[torch.bitwise_xor(x, y).long()], dim=(-2, -1))
    return (v_length - ham).to(torch.float32) / v_length

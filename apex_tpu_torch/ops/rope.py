"""Rotary position embeddings (``apex_tpu/ops/rope.py``), the layouts the
serving path and packed (THD) attention use, in plain PyTorch (the JAX
package wrote these in XLA, not Pallas, so there is no kernel to port).

NeoX "rotate_half" rotation with partial rotation: for rotary dim
``d2 = cos.shape[-1] <= d``::

    out[..., :d2] = t[..., :d2]·cos + rotate_half(t[..., :d2])·sin
    out[..., d2:] = t[..., d2:]

computed in fp32 and cast back to ``t``'s dtype.
"""

from __future__ import annotations

import torch

__all__ = ["_rope", "fused_apply_rotary_pos_emb",
           "fused_apply_rotary_pos_emb_cached",
           "fused_apply_rotary_pos_emb_thd",
           "fused_apply_rotary_pos_emb_ragged"]


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rope(t, cos, sin):
    """Rotate the first ``d2`` features of ``t``; ``cos``/``sin`` (fp32)
    broadcast against ``t[..., :d2]``."""
    d2 = cos.shape[-1]
    t32 = t[..., :d2].float()
    out = (t32 * cos + _rotate_half(t32) * sin).to(t.dtype)
    if d2 < t.shape[-1]:
        out = torch.cat([out, t[..., d2:]], dim=-1)
    return out


def fused_apply_rotary_pos_emb(t, freqs):
    """``sbhd`` layout: ``t`` ``[s, b, h, d]``, ``freqs`` ``[s, 1, 1, d2]``
    angles in radians."""
    f32 = freqs.float()
    return _rope(t, torch.cos(f32), torch.sin(f32))


def fused_apply_rotary_pos_emb_thd(t, cu_seqlens, freqs):
    """``thd`` packed layout: ``t`` ``[T, h, d]``, ``cu_seqlens``
    ``[docs + 1]`` cumulative starts, ``freqs`` ``[max_s, 1, 1, d2]``: token
    ``i`` of the document whose range holds it rotates by its position in
    that document, ``i - cu_seqlens[doc(i)]`` (the layout of
    ``ops/flash_attention.flash_attention_packed``).  Padding tokens past
    ``cu_seqlens[-1]`` take a row clamped to the table."""
    total = t.shape[0]
    cu = torch.as_tensor(cu_seqlens, device=t.device).to(torch.int64)
    idx = torch.arange(total, device=t.device)
    doc = torch.searchsorted(cu, idx, right=True) - 1
    pos = (idx - cu[doc.clamp(0, cu.shape[0] - 1)]).clamp(
        0, freqs.shape[0] - 1)
    f32 = freqs.float().reshape(freqs.shape[0], -1)
    return _rope(t, torch.cos(f32)[pos][:, None, :],
                 torch.sin(f32)[pos][:, None, :])


def fused_apply_rotary_pos_emb_cached(t, cos_, sin_):
    """Precomputed ``cos_``/``sin_`` broadcastable to ``t``
    (``[s, 1, 1, d2]`` for sbhd, ``[1, s, 1, d2]`` for bshd)."""
    return _rope(t, cos_.float(), sin_.float())


def fused_apply_rotary_pos_emb_ragged(t, cos_, sin_, positions):
    """``t`` ``[b, s, h, d]``, tables ``[max_len, d2]``, ``positions``
    ``[b]`` int: token (i, j) rotates by table row ``positions[i] + j``,
    clamped to the table (a finished sequence past ``max_len`` reads a
    valid, ignored row)."""
    b, s = t.shape[0], t.shape[1]
    pos = torch.as_tensor(positions, device=t.device).to(torch.long)
    pos = pos.expand(b) if pos.ndim == 0 else pos
    rows = pos[:, None] + torch.arange(s, device=t.device)[None]
    rows = rows.clamp(0, cos_.shape[0] - 1)
    cos_g = cos_.float()[rows][:, :, None, :]
    sin_g = sin_.float()[rows][:, :, None, :]
    return _rope(t, cos_g, sin_g)

"""Overlapping spatial tiling (port of reface_tpu/parallel/tiling.py), NCHW.

Splits a latent or an image into overlapping tiles, runs a network on all
of them as ONE batched call (never a per-tile loop), and folds the outputs
back with border weights that decay toward each tile's edges, normalised
by their sum. Tiles are grouped tile-major, [tile0 x B, tile1 x B, ...], so
a caller broadcasts per-sample inputs (timesteps, context) by repeating
whole batches. The VAE encode folds at scale 1/8 and the decode at 8.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["unfold", "fold", "tiled_apply", "border_weights"]


def _starts(size: int, tile: int, stride: int) -> np.ndarray:
    if size <= tile:
        return np.array([0])
    s = np.arange(0, size - tile + 1, stride)
    if s[-1] != size - tile:
        s = np.append(s, size - tile)
    return s


def border_weights(tile: int, power: float = 1.0) -> np.ndarray:
    """(tile, tile) float32 weights: the outer product of a triangular ramp
    (float64, normalised to a peak of 1), normalised to a peak of 1."""
    ramp = np.minimum(np.arange(1, tile + 1), np.arange(tile, 0, -1)).astype(
        np.float64
    )
    ramp = (ramp / ramp.max()) ** power
    w = np.outer(ramp, ramp)
    return (w / w.max()).astype(np.float32)


def unfold(x: torch.Tensor, tile: int, stride: int):
    """(B,C,H,W) -> (T*B, C, tile, tile) overlapping tiles, tile-major, and
    the metadata fold needs."""
    b, _, h, w = x.shape
    ys = _starts(h, tile, stride)
    xs = _starts(w, tile, stride)
    tiles = [x[:, :, y0: y0 + tile, x0: x0 + tile] for y0 in ys for x0 in xs]
    meta = dict(ys=ys, xs=xs, batch=b, h=h, w=w, tile=tile)
    return torch.cat(tiles, dim=0), meta


def fold(tiles: torch.Tensor, meta: dict, out_channels: int | None = None,
         scale: float = 1) -> torch.Tensor:
    """Weighted fold of (T*B, C, t*s, t*s) tiles back to (B, C, H*s, W*s).

    scale may be fractional (1/8 for a VAE encode) as long as every tile
    start and the tile size stay integral after scaling."""
    b = meta["batch"]
    tile = int(round(meta["tile"] * scale))
    h, w = int(round(meta["h"] * scale)), int(round(meta["w"] * scale))
    c = out_channels or tiles.shape[1]
    weights = torch.as_tensor(border_weights(tile), device=tiles.device)[None, None]
    acc = torch.zeros((b, c, h, w), dtype=tiles.dtype, device=tiles.device)
    norm = torch.zeros((1, 1, h, w), dtype=tiles.dtype, device=tiles.device)
    i = 0
    for y0 in meta["ys"]:
        for x0 in meta["xs"]:
            y, x = int(round(y0 * scale)), int(round(x0 * scale))
            acc[:, :, y: y + tile, x: x + tile] += tiles[i * b: (i + 1) * b] * weights
            norm[:, :, y: y + tile, x: x + tile] += weights
            i += 1
    return acc / torch.clamp(norm, min=1e-8)


def tiled_apply(fn, x: torch.Tensor, tile: int, stride: int,
                out_channels: int | None = None, scale: float = 1) -> torch.Tensor:
    """Apply fn to overlapping tiles as ONE batched call and fold back.

    fn: (N, C, tile, tile) -> (N, C', tile*scale, tile*scale), e.g. a VAE
    decode (scale=8) or a UNet eps prediction (scale=1).
    """
    tiles, meta = unfold(x, tile, stride)
    return fold(fn(tiles), meta, out_channels=out_channels, scale=scale)

"""Walker / Vose alias tables: O(1) discrete sampling of the IBL
environment map (port of libyafaray_tpu/lights/alias.py).  The table is
built once per scene compile on the host (numpy); a draw is two gathers
(prob, alias) whatever the table size.  The coin that picks the cell or
its alias is rescaled to a fresh uniform on its branch, which the caller
uses as an in-cell offset."""
from __future__ import annotations

import numpy as np
import torch


def build_alias_table(weights: np.ndarray):
    """weights (N,) >= 0 -> (prob (N,) float32, alias (N,) int32): drawing
    i = floor(u·N), taking i if frac < prob[i] else alias[i], gives
    P(k) = weights[k] / sum(weights).  Degenerate weights give the uniform
    table."""
    w = np.asarray(weights, np.float64).ravel()
    n = w.size
    total = w.sum()
    if not np.isfinite(total) or total <= 0.0:
        return (np.ones(n, np.float32), np.arange(n, dtype=np.int32))
    scaled = w * (n / total)
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        big = large.pop()
        prob[s] = scaled[s]
        alias[s] = big
        scaled[big] = (scaled[big] + scaled[s]) - 1.0
        if scaled[big] < 1.0:
            small.append(big)
        else:
            large.append(big)
    for i in small + large:
        prob[i] = 1.0
    return prob.astype(np.float32), alias


def sample_alias(prob: torch.Tensor, alias: torch.Tensor, u: torch.Tensor):
    """u (L,) in [0, 1) -> (cell (L,) int32, u_rest (L,) float32), u_rest a
    fresh uniform from the rescaled coin."""
    n = prob.shape[0]
    z = torch.clamp(u * n, 0.0, n * (1.0 - 1e-7))
    i = z.to(torch.int32)
    coin = z - i.to(torch.float32)
    p = prob[i.long()]
    take_alias = coin >= p
    cell = torch.where(take_alias, alias[i.long()], i)
    # coin | coin < p ~ U[0, p), coin | coin >= p ~ U[p, 1): both to U[0, 1)
    u_rest = torch.where(take_alias,
                         (coin - p) / torch.clamp(1.0 - p, min=1e-12),
                         coin / torch.clamp(p, min=1e-12))
    return cell, torch.clamp(u_rest, 0.0, 1.0 - 1e-7)

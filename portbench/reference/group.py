"""The upstream study's group-level null, written plainly, to judge the program by.

Upstream (mitjanikolaus/multimodal_decoding,
``searchlight_permutation_testing.py``) draws its group permutations as the
first tuples of ``itertools.permutations(range(P), S)`` (``:504-506``): a
permutation gives subject s its within-subject null map number ``perm[s]``.
Each member metric of the composite gives a one-sample t-map over the
subjects (``ttest_1samp_no_p``, ``:213-242``: the mean over the standard
error with ``ddof=1``; a vertex whose subjects all score alike is NaN,
``:245-251``), the composite is the members' minimum ignoring NaN
(``:271-291``), TFCE (``cluster_analysis.py:248-312``) turns it into a map,
and the permutation's statistic is that map's largest value over both
hemispheres.  TFCE, as ``calc_tfce_values`` states it: thresholds
``arange(dh, max + dh, dh)``; at each, the edges whose both ends score at
least the threshold join clusters of the vertices they touch, each such
vertex gaining ``extent ** e * threshold ** h * dh`` with the extent its
cluster's count of vertices, and a vertex that no such edge touches and that
scores above the threshold (strictly) gaining ``threshold ** h * dh``; a map
whose maximum is not a positive finite number is all zero.

Everything here is float64 and plain torch, and imports nothing of the
program: the permutations are unranked here, the clusters found here by
label propagation over every threshold at once.
"""

from __future__ import annotations

import numpy as np
import torch


def permutation(rank: int, n: int, k: int) -> list:
    """The ``rank``-th (from 0) k-tuple of distinct elements of ``range(n)`` in
    lexicographic order, as ``itertools.permutations(range(n), k)`` yields them."""
    free, out = list(range(n)), []
    for i in range(k):
        completions = 1
        for j in range(n - k + 1, n - i):
            completions *= j
        idx, rank = divmod(rank, completions)
        out.append(free.pop(idx))
    return out


def t_min(rows: list, popmeans: list) -> torch.Tensor:
    """The composite's null t-map: ``rows`` holds each member's [S, V] scores
    of one permutation (any float dtype), ``popmeans`` its chance level.
    Float64 [V]; NaN where no member has a t-value or the minimum is infinite."""
    best = None
    for x, popmean in zip(rows, popmeans):
        x = x.to(torch.float64)
        n = x.shape[0]
        d = x - popmean
        mean = d.mean(dim=0)
        var = ((d - mean) ** 2).sum(dim=0) / (n - 1)
        t = mean / torch.sqrt(var / n)
        t = torch.where((x == x[:1]).all(dim=0), torch.full_like(t, float("nan")), t)
        best = t if best is None else torch.fmin(best, t)
    return torch.where(torch.isinf(best), torch.full_like(best, float("nan")), best)


def components(n: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Connected components of the graph on ``n`` nodes with edges (a[i], b[i]):
    each node's label is the least node of its component.  Minimum labels are
    hooked across the edges and the label trees shortened to stars, until
    nothing moves (then every edge's ends carry one label)."""
    parent = torch.arange(n, device=a.device)
    while True:
        before = parent
        pa, pb = parent[a], parent[b]
        low = torch.minimum(pa, pb)
        parent = parent.clone()
        for idx in (pa, pb, a, b):
            parent.scatter_reduce_(0, idx, low, reduce="amin")
        while True:
            hop = parent[parent]
            if torch.equal(hop, parent):
                break
            parent = hop
        if torch.equal(parent, before):
            return parent


def tfce(values: torch.Tensor, edges: torch.Tensor, h: float, e: float, dh: float,
         group: int = 32) -> torch.Tensor:
    """TFCE of one map, vertex extents: ``values`` [V] (NaN allowed),
    ``edges`` [E, 2] int64 on the same device.  Float64 [V].  The thresholds
    are taken ``group`` at a time, each a copy of the graph."""
    v = values.shape[0]
    out = torch.zeros(v, dtype=torch.float64, device=values.device)
    values = values.to(torch.float64)
    finite = values[~torch.isnan(values)]
    if finite.numel() == 0:
        return out
    top = float(finite.max())
    if not np.isfinite(top) or top <= 0:
        return out
    step = top / 100 if dh == 0 else dh
    thresholds = torch.as_tensor(np.arange(step, top + step, step), dtype=torch.float64,
                                 device=values.device)
    for lo in range(0, len(thresholds), group):
        ths = thresholds[lo:lo + group]
        t = len(ths)
        at_least = values[None, :] >= ths[:, None]
        joined = at_least[:, edges[:, 0]] & at_least[:, edges[:, 1]]
        level, edge = joined.nonzero(as_tuple=True)
        a = level * v + edges[edge, 0]
        b = level * v + edges[edge, 1]
        label = components(t * v, a, b)
        clustered = torch.zeros(t * v, dtype=torch.bool, device=values.device)
        clustered[a] = True
        clustered[b] = True
        extent = torch.bincount(label[clustered], minlength=t * v).to(torch.float64)
        weight = (ths ** h * step).repeat_interleave(v)
        single = (values[None, :] > ths[:, None]).reshape(-1) & ~clustered
        gain = torch.where(clustered, extent[label] ** e, single.to(torch.float64)) * weight
        out += gain.reshape(t, v).sum(dim=0)
    return out


def largest(tfce_map: torch.Tensor) -> float:
    """The map's largest value, NaN left out (-inf where all are NaN)."""
    finite = tfce_map[~torch.isnan(tfce_map)]
    return float(finite.max()) if finite.numel() else float("-inf")

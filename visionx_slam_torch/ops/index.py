"""Index helpers: stable selection with the JAX package's tie order,
batched row gathers, and deterministic segment sums.

``jax.lax.top_k`` and ``jnp.argsort`` are stable (on ties the lower index
comes first); ``torch.topk`` is not, and ``torch.argsort`` defaults to
``stable=False``. Every top-k and sort of the port goes through here or
passes ``stable=True``, so tie order matches the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def stable_topk(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest along ``dim``, lower index first
    on ties — ``jax.lax.top_k`` semantics."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def stable_argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Ascending argsort, lower index first on ties (``jnp.argsort``)."""
    return torch.argsort(x, dim=dim, stable=True)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x [P, N, d] at idx [P, *J] (per batch row p) -> [P, *J, d]."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(x, 1, flat[..., None].expand(*flat.shape, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


class Segments(NamedTuple):
    """Rows grouped by segment id: sorted once, summed by ``segment_sum``
    as often as needed (the JAX package's sorted segment sums)."""

    order: torch.Tensor    # [R] int64 stable argsort of the ids
    lengths: torch.Tensor  # [n] int64 rows of segments 0..n-1


def segments(ids: torch.Tensor, n: int,
             order: torch.Tensor | None = None) -> Segments:
    """Segments 0..n-1 of the rows of ``ids`` [R] (non-negative; rows with
    an id >= n, a spare row, belong to none). ``order``: the caller's
    stable argsort of ``ids``, or of any ids that sort the same way."""
    ids = ids.long()
    if order is None:
        order = stable_argsort(ids)
    bounds = torch.searchsorted(ids[order], torch.arange(n + 1, device=ids.device))
    return Segments(order, bounds.diff())


def segment_sum(x: torch.Tensor, segs: Segments) -> torch.Tensor:
    """x [R, ...] summed per segment -> [n, ...]; an empty segment sums
    to 0. Each segment adds its rows one after another in their original
    order, so on the CPU the result equals ``index_add_`` into zeros bit
    for bit, and on CUDA it is the same bits in every run (one thread per
    output element walks its segment), where ``index_add_`` adds with
    atomics in any order. Integers are summed as float64 (exact below
    2**53)."""
    if not x.is_floating_point():
        return segment_sum(x.double(), segs).to(x.dtype)
    flat = x.reshape(x.shape[0], -1)    # 2-D: every device walks in order
    out = torch.segment_reduce(flat[segs.order], "sum", lengths=segs.lengths,
                               unsafe=True)
    return out.reshape(-1, *x.shape[1:])

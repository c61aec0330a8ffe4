"""Index helpers: stable selection with the JAX package's tie order, and
batched row gathers.

``jax.lax.top_k`` and ``jnp.argsort`` are stable (on ties the lower index
comes first); ``torch.topk`` is not, and ``torch.argsort`` defaults to
``stable=False``. Every top-k and sort of the port goes through here or
passes ``stable=True``, so tie order matches the JAX package.
"""

from __future__ import annotations

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

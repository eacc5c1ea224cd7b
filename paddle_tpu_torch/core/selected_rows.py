"""Sparse row-wise gradients — counterpart of
``paddle_tpu/core/selected_rows.py``.

A ``SelectedRows`` is ``{rows, values}`` over a dense ``[height, *dim]``
gradient, built over torch's sparse COO tensor: ``rows`` are its first
index row, ``values`` its values.  ``rows`` may repeat (one entry per
lookup): accumulation stays uncoalesced, and ``merged()`` gives the
deduplicated, summed form (sorted rows) that the sparse optimizer rules
consume.  ``embedding(..., sparse=True)`` leaves such a gradient on its
weight; the handle's ``grad`` then reads as a ``SelectedRows``.

It is a ``Tensor`` whose dense form is computed lazily: anything that
touches ``_data`` (an op, ``numpy()``) gets the scatter-added dense
tensor; ``shape`` and ``dtype`` never densify.  Assigning ``_data``
makes the dense tensor the representation (rows ``0..height``), so a
consumer of ``merged()`` sees the write.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as device_mod
from . import dtype as dtypes
from .tensor import Tensor


def _as_torch(x, device, dtype=None):
    if isinstance(x, Tensor):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
        x = x.to(device)
    return x if dtype is None else x.to(dtype)


class SelectedRows(Tensor):
    """{rows, values} over a dense ``[height, *dim]`` gradient."""

    def __init__(self, rows, values, height, name=None):
        device = (values.device if isinstance(values, torch.Tensor)
                  else values._data.device if isinstance(values, Tensor)
                  else device_mod.torch_device())
        rows = _as_torch(rows, device, torch.int64).reshape(-1)
        values = _as_torch(values, device)
        if values.shape[0] != rows.shape[0]:
            raise ValueError(
                "SelectedRows: values.shape[0] (%d) != len(rows) (%d)"
                % (values.shape[0], rows.shape[0]))
        height = int(height)
        self._set_sparse(torch.sparse_coo_tensor(
            rows[None], values, (height,) + tuple(values.shape[1:]),
            check_invariants=False), name)

    def _set_sparse(self, sp, name=None):
        self._sp = sp
        self._dense = None
        self._merged_cache = None
        self._init_meta(name)
        self.name = name or f"selected_rows_{Tensor._next_id[0]}"

    @classmethod
    def from_sparse(cls, sp, name=None):
        """Wrap a torch sparse COO tensor (no copy)."""
        out = cls.__new__(cls)
        out._set_sparse(sp, name)
        return out

    @classmethod
    def from_merged(cls, rows, values, height):
        """From rows already known unique: primes the merged cache, so a
        consumer skips the merge."""
        out = cls(rows, values, height)
        out._merged_cache = (out.rows, out.values)
        return out

    def sparse(self):
        """The torch sparse COO tensor (possibly uncoalesced)."""
        return self._sp

    # -- sparse surface ---------------------------------------------------
    @property
    def rows(self):
        return self._sp._indices()[0]

    @property
    def values(self):
        return self._sp._values()

    @property
    def height(self):
        return int(self._sp.shape[0])

    def merged(self):
        """(unique rows, summed values), the rows sorted; cached."""
        if self._merged_cache is None:
            c = self._sp.coalesce()
            self._merged_cache = (c.indices()[0], c.values())
        return self._merged_cache

    def append(self, other: "SelectedRows") -> "SelectedRows":
        """Sparse + sparse accumulation: the entries concatenated."""
        if other.height != self.height or \
                other.values.shape[1:] != self.values.shape[1:]:
            raise ValueError("SelectedRows shape mismatch in accumulation")
        return SelectedRows(
            torch.cat([self.rows, other.rows]),
            torch.cat([self.values, other.values.to(self.values.dtype)]),
            self.height)

    def is_densified(self):
        return self._dense is not None

    # -- Tensor compatibility ---------------------------------------------
    @property
    def _data(self):
        if self._dense is None:
            self._dense = self._sp.to_dense()
        return self._dense

    @_data.setter
    def _data(self, v):
        v = torch.as_tensor(v)
        h = self.height
        rows = torch.arange(h, device=v.device)
        self._sp = torch.sparse_coo_tensor(rows[None], v, tuple(v.shape),
                                           check_invariants=False)
        self._dense = v
        self._merged_cache = (rows, v)

    @property
    def stop_gradient(self):
        return True

    @stop_gradient.setter
    def stop_gradient(self, value):
        pass

    @property
    def grad(self):
        return None

    @property
    def shape(self):
        return list(self._sp.shape)

    @property
    def ndim(self):
        return self._sp.dim()

    @property
    def size(self):
        return int(np.prod(self.shape))

    @property
    def dtype(self):
        return dtypes.canonical_name(self._sp.dtype)

    @property
    def place(self):
        return device_mod.place_of(self._sp)

    def __len__(self):
        return self.height

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={int(self.rows.shape[0])}, "
                f"dim={list(self.values.shape[1:])}, dtype={self.dtype})")


def wrap_grad(g):
    """A handle over a torch gradient: ``SelectedRows`` when it is sparse."""
    if g.is_sparse:
        return SelectedRows.from_sparse(g)
    return Tensor._wrap(g)


def get_tensor_from_selected_rows(x, name=None):
    """Densify a ``SelectedRows``; a dense tensor passes through."""
    if isinstance(x, SelectedRows):
        return Tensor._wrap(x._data)
    return x

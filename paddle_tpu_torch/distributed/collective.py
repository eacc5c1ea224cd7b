"""The two collectives of the serving mesh, over one mesh axis's ranks.

These are what GSPMD inserts in the JAX engine's tensor-parallel
program: the sum over mp after the row-parallel products (``out_weight``,
``fc2``, the vocab-parallel embedding) and the all-gather of the
column-parallel head's vocab-split logits.  ``parts[i]`` lies on
``group[i]``; each part moves to the group's first device, the result is
formed there, and it is copied back only to the devices that differ, so
on one device the sum is an add and the gather a ``cat``.  The result is
a list with one tensor per rank; ranks on one device share it.

Each call runs under a ``torch.profiler`` label (``mesh.all_reduce_sum``,
``mesh.all_gather``) so a profile can attribute the collectives' device
time.
"""
from __future__ import annotations

import torch


def _scatter_back(out, group):
    placed = {out.device: out}
    for dev in group:
        if dev not in placed:
            placed[dev] = out.to(dev)
    return [placed[dev] for dev in group]


def all_reduce_sum(parts, group):
    """Sum of ``parts`` (rank order), on every rank's device."""
    if len(parts) != len(group):
        raise ValueError(f"all_reduce_sum: {len(parts)} parts for a group "
                         f"of {len(group)} ranks")
    with torch.profiler.record_function("mesh.all_reduce_sum"):
        dev = group[0]
        out = parts[0].to(dev)
        for p in parts[1:]:
            out = out + p.to(dev)
        return _scatter_back(out, group)


def all_gather(parts, dim, group):
    """``parts`` (rank order) concatenated on ``dim``, on every rank's
    device."""
    if len(parts) != len(group):
        raise ValueError(f"all_gather: {len(parts)} parts for a group of "
                         f"{len(group)} ranks")
    with torch.profiler.record_function("mesh.all_gather"):
        dev = group[0]
        out = (parts[0].to(dev) if len(parts) == 1
               else torch.cat([p.to(dev) for p in parts], dim=dim))
        return _scatter_back(out, group)

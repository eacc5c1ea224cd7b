"""Parameter-server analogue: mesh-sharded sparse embedding tables —
counterpart of ``paddle_tpu/distributed/ps.py``.

Reference parity: the reference's PS stack — brpc services
(``distributed/service/brpc_ps_server.cc``), the Table hierarchy
(``distributed/table/common_sparse_table.cc:40`` shard-locked dense-block
storage with per-row SGD/Adam rules in ``table/depends/dense.h``), the
trainer-side communicator (``operators/distributed/communicator.cc``) and
the ``the_one_ps.py:378`` runtime facade.

As in the JAX package there are no server processes: a table is a dense
``[rows, dim]`` array split by rows over the mesh's ``sharding`` ranks
when the count divides (else replicated: one copy a distinct device),
each shard a tensor on its rank's device.  Pull is a gather from the
shards, push the O(batch) update of the touched rows: unique ids, an
``index_add_`` merge of the duplicates' gradients, a gather of the
touched rows and their per-row Adam state (``m``, ``v`` and a per-row
step count ``t``), the rule, and a delta scatter back — nothing the size
of the table is allocated.  ``HashedSparseTable`` keeps a host-side
id->slot map over a slab that doubles when full (clamped at
``max_rows``) and evicts with ``shrink(ttl)``; ``GeoSparseTable`` /
``GeoWorkerTable`` are the geo-async mode (worker-local replicas, an
interval delta flush merged by sum, per-trainer refresh sets).
``save`` / ``load`` write and read the JAX package's files
(``<name>.meta``, ``<name>.shard<i>``, ``.idmap``, ``.geo`` and the
legacy ``<name>.table``), so a table saved by either package loads into
the other.  A table lives in one process: its mesh may not span
processes.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from . import mesh as mesh_mod
from . import process

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _ids(ids):
    from ..core.tensor import Tensor
    if isinstance(ids, Tensor):
        ids = ids._data
    if isinstance(ids, torch.Tensor):
        return ids.detach()
    return torch.as_tensor(np.asarray(ids))


def _host(t):
    return t.detach().cpu().numpy()


class SparseTable:
    """Row-sharded embedding table with per-row optimizer state
    (reference: CommonSparseTable + its sgd/adam rules)."""

    def __init__(self, name, rows, dim, optimizer="sgd", lr=0.01,
                 initializer=None, mesh=None):
        self.name = name
        self.rows = int(rows)
        self.dim = int(dim)
        self.optimizer = optimizer
        self.lr = float(lr)
        self.mesh = mesh if mesh is not None else mesh_mod.ensure_mesh()
        if getattr(self.mesh, "spans_processes", False):
            raise NotImplementedError(
                f"SparseTable {name}: a table lives in one process; its "
                "mesh spans processes (build it over this process's "
                "devices)")
        self._initializer = initializer
        self._place(self._init_rows(self.rows), self._zero_state(self.rows))

    # -- placement ---------------------------------------------------------
    def _layout(self, rows):
        """``[(lo, hi, device)]``: row shards over the ``sharding`` ranks
        when ``rows`` divides over them, else one whole copy a distinct
        device — re-evaluated on every capacity change."""
        n = max(self.mesh.axis_size("sharding"), 1)
        if n > 1 and rows % n == 0:
            devs = self.mesh.axis_devices("sharding")
            per = rows // n
            return [(i * per, (i + 1) * per, devs[i]) for i in range(n)]
        return [(0, rows, d) for d in dict.fromkeys(self.mesh.flat_devices)]

    @property
    def sharded(self):
        return self._shards[0][1] - self._shards[0][0] < self.rows

    def _place(self, weight, state):
        """Lay ``weight`` and ``state`` (full host or device tensors) out
        as this table's shards."""
        self._shards = []
        for lo, hi, dev in self._layout(self.rows):
            sh = {"weight": weight[lo:hi].to(dev, copy=True)}
            for k, v in state.items():
                sh[k] = v[lo:hi].to(dev, copy=True)
            self._shards.append((lo, hi, dev, sh))

    def _zero_state(self, n):
        if self.optimizer != "adam":
            return {}
        return {"m": torch.zeros(n, self.dim), "v": torch.zeros(n, self.dim),
                "t": torch.zeros(n, dtype=torch.int32)}

    def _init_rows(self, n):
        """Fresh row values per the table's initializer (also used when
        the hashed subclass grows its slab)."""
        if self._initializer is None:
            scale = 1.0 / np.sqrt(self.dim)
            return torch.empty(n, self.dim).uniform_(-scale, scale)
        return torch.as_tensor(np.asarray(
            self._initializer((n, self.dim), "float32"), np.float32))

    def _gather_full(self, key):
        """The whole of ``weight`` or a state tensor, on the first
        shard's device (a read for checks and saving, never a push)."""
        if not self.sharded:
            return self._shards[0][3][key]
        dev = self._shards[0][2]
        return torch.cat([sh[key].to(dev) for _, _, _, sh in self._shards])

    @property
    def weight(self):
        return self._gather_full("weight")

    @property
    def state(self):
        return {k: self._gather_full(k) for k in ("m", "v", "t")
                if k in self._shards[0][3]}

    @property
    def device(self):
        return self._shards[0][2]

    # -- RPC-shaped API (reference PsService pull/push, sendrecv.proto) --
    def pull(self, ids):
        """Gather rows for ids (trainer 'pull_sparse'), in the ids' shape
        plus ``dim``, on the first shard's device."""
        ids = _ids(ids)
        flat = ids.reshape(-1).to(self.device, torch.int64)
        if not self.sharded:
            out = self._shards[0][3]["weight"].index_select(0, flat)
        else:
            out = torch.empty(flat.numel(), self.dim, device=self.device)
            for lo, hi, dev, sh in self._shards:
                pos = ((flat >= lo) & (flat < hi)).nonzero().reshape(-1)
                if pos.numel():
                    rows = sh["weight"].index_select(
                        0, (flat.index_select(0, pos) - lo).to(dev))
                    out.index_copy_(0, pos, rows.to(self.device))
        return out.reshape(tuple(ids.shape) + (self.dim,))

    @torch.no_grad()
    def push(self, ids, grads):
        """Apply grads to touched rows (trainer 'push_sparse').  Repeated
        ids accumulate (the ``index_add_`` merge), matching SelectedRows
        merge-add; the cost is O(batch), whatever the table's size."""
        ids = _ids(ids).reshape(-1).to(self.device, torch.int64)
        g = (grads if isinstance(grads, torch.Tensor)
             else torch.as_tensor(np.asarray(grads)))
        g = g.detach().reshape(-1, self.dim).to(self.device, torch.float32)
        uids, inv = torch.unique(ids, return_inverse=True)
        merged = torch.zeros(uids.numel(), self.dim, device=self.device)
        merged.index_add_(0, inv, g)
        for lo, hi, dev, sh in self._shards:
            if self.sharded:
                pos = ((uids >= lo) & (uids < hi)).nonzero().reshape(-1)
                if not pos.numel():
                    continue
                local = (uids.index_select(0, pos) - lo).to(dev)
                mg = merged.index_select(0, pos).to(dev)
            else:
                local, mg = uids.to(dev), merged.to(dev)
            self._update_rows(sh, local, mg)

    def _update_rows(self, sh, local, mg):
        """The rule on the touched rows ``local`` of one shard, as delta
        scatters (each row once: ``local`` is unique)."""
        w_rows = sh["weight"].index_select(0, local)
        if self.optimizer == "adam":
            # per-row step counts: each touched row advances its own t
            # and bias-corrects with it (reference per-row state)
            t_rows = sh["t"].index_select(0, local) + 1
            m_rows = sh["m"].index_select(0, local)
            v_rows = sh["v"].index_select(0, local)
            m_new = _B1 * m_rows + (1 - _B1) * mg
            v_new = _B2 * v_rows + (1 - _B2) * mg ** 2
            tf = t_rows.to(torch.float32)[:, None]
            mhat = m_new / (1 - _B1 ** tf)
            vhat = v_new / (1 - _B2 ** tf)
            new_rows = w_rows - self.lr * mhat / (torch.sqrt(vhat) + _EPS)
            sh["m"].index_add_(0, local, m_new - m_rows)
            sh["v"].index_add_(0, local, v_new - v_rows)
            sh["t"].index_add_(0, local, torch.ones_like(t_rows))
        else:
            new_rows = w_rows - self.lr * mg
        sh["weight"].index_add_(0, local, new_rows - w_rows)

    # -- persistence (reference: table save/load to dirname shards;
    # common_sparse_table.cc Save writes one file per shard) -------------
    def save(self, dirname, num_shards=None):
        """Write the table as ``num_shards`` row-range shard files
        (default: one per mesh 'sharding' slice), the JAX package's
        files."""
        os.makedirs(dirname, exist_ok=True)
        if num_shards is None:
            num_shards = max(self.mesh.axis_size("sharding"), 1)
        bounds = np.linspace(0, self.rows, num_shards + 1, dtype=np.int64)
        meta = {"rows": self.rows, "dim": self.dim,
                "optimizer": self.optimizer, "lr": self.lr,
                "num_shards": int(num_shards),
                "bounds": bounds.tolist()}
        with open(os.path.join(dirname, f"{self.name}.meta"), "wb") as f:
            pickle.dump(meta, f, protocol=4)
        full = {"weight": _host(self.weight)}
        full.update({k: _host(v) for k, v in self.state.items()})
        for s in range(num_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            blob = {k: np.ascontiguousarray(full[k][lo:hi])
                    for k in ("weight", "m", "v", "t") if k in full}
            with open(os.path.join(
                    dirname, f"{self.name}.shard{s}"), "wb") as f:
                pickle.dump(blob, f, protocol=4)

    def load(self, dirname):
        meta_path = os.path.join(dirname, f"{self.name}.meta")
        legacy = os.path.join(dirname, f"{self.name}.table")
        if not os.path.exists(meta_path) and os.path.exists(legacy):
            with open(legacy, "rb") as f:  # round-1 single-file format
                data = pickle.load(f)
            state = {}
            for k, v in data["state"].items():
                arr = np.asarray(v)
                if k == "t" and arr.ndim == 0:
                    # legacy scalar step count -> per-row
                    arr = np.full((self.rows,), arr, np.int32)
                state[k] = torch.as_tensor(arr)
            self._place(torch.as_tensor(np.asarray(data["weight"])), state)
            return
        with open(meta_path, "rb") as f:
            meta = pickle.load(f)
        if (meta["rows"], meta["dim"]) != (self.rows, self.dim):
            raise ValueError(
                f"table {self.name}: stored shape "
                f"({meta['rows']},{meta['dim']}) != constructed "
                f"({self.rows},{self.dim})")
        bounds = meta["bounds"]
        w = np.empty((self.rows, self.dim), np.float32)
        adam = self.optimizer == "adam"
        state_np = {k: np.empty((self.rows, self.dim), np.float32)
                    for k in ("m", "v")} if adam else {}
        t_np = np.zeros((self.rows,), np.int32) if adam else None
        for s in range(meta["num_shards"]):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            with open(os.path.join(
                    dirname, f"{self.name}.shard{s}"), "rb") as f:
                blob = pickle.load(f)
            w[lo:hi] = blob["weight"]
            for k in state_np:
                state_np[k][lo:hi] = blob[k]
            if adam:
                if "t" in blob:
                    t_np[lo:hi] = blob["t"]
                else:  # shards written before per-row counts
                    t_np[lo:hi] = int(meta.get("state_t", 0))
        state = {}
        if adam:
            state = {"m": torch.as_tensor(state_np["m"]),
                     "v": torch.as_tensor(state_np["v"]),
                     "t": torch.as_tensor(t_np)}
        self._place(torch.as_tensor(w), state)


class HashedSparseTable(SparseTable):
    """Unbounded-id sparse table: arbitrary int64 feature ids map to
    slots in a growing slab (reference:
    ``table/common_sparse_table.cc:40`` unbounded hash buckets +
    ``MemorySparseTable``'s shard hash maps, and ``Shrink`` for decay).

    The reference's hash table is host-side — C++ unordered maps in
    server RAM, the accelerator never seeing raw ids — and so is this
    one: the id->slot assignment is a host dict (amortized O(1) per id,
    unbounded key space) while rows and optimizer state live sharded on
    the mesh exactly like ``SparseTable``; when the slab fills, capacity
    doubles (bounded by ``max_rows``) and the shards are laid out anew.
    Pull/push stay O(batch) device work; only the host map touches the
    raw ids.  ``shrink`` evicts rows untouched for ``ttl`` pushes,
    freeing slots for reuse (reference: Table::Shrink TTL semantics).
    """

    def __init__(self, name, dim, initial_rows=1024, max_rows=None,
                 **kwargs):
        super().__init__(name, initial_rows, dim, **kwargs)
        self.max_rows = None if max_rows is None else int(max_rows)
        self._slot_of = {}            # id (python int) -> slot
        self._free = list(range(self.rows - 1, -1, -1))
        self._last_touch = np.zeros((self.rows,), np.int64)
        self._push_count = 0

    @property
    def size(self):
        """Live (assigned) row count — the reference's table size."""
        return len(self._slot_of)

    def _grow(self):
        new_rows = self.rows * 2
        if self.max_rows is not None:
            if self.rows >= self.max_rows:
                raise RuntimeError(
                    f"HashedSparseTable {self.name}: max_rows "
                    f"{self.max_rows} exhausted (live ids: {self.size})")
            new_rows = min(new_rows, self.max_rows)
        extra = new_rows - self.rows
        weight = torch.cat([self.weight.cpu(), self._init_rows(extra)])
        state = {k: torch.cat([v.cpu(), z]) for (k, v), z in zip(
            self.state.items(), self._zero_state(extra).values())}
        self._free.extend(range(new_rows - 1, self.rows - 1, -1))
        self._last_touch = np.concatenate(
            [self._last_touch, np.zeros((extra,), np.int64)])
        self.rows = new_rows
        # a max_rows clamp can leave new_rows non-divisible by the
        # shard axis: the layout is re-evaluated
        self._place(weight, state)

    def _assign(self, ids):
        """Host-side id->slot mapping.  Unseen ids allocate a fresh slot
        (growing the slab when full) on pull as well as push — the
        reference likewise initializes a row on first access."""
        ids_np = _ids(ids).cpu().numpy().reshape(-1)
        out = np.empty((ids_np.size,), np.int64)
        for i, raw in enumerate(ids_np.tolist()):
            slot = self._slot_of.get(raw)
            if slot is None:
                if not self._free:
                    self._grow()
                slot = self._free.pop()
                self._slot_of[raw] = slot
            out[i] = slot
            self._last_touch[slot] = self._push_count
        return out

    def slots(self, ids):
        """The slots of ``ids`` (assigning unseen ones), in their shape."""
        raw = _ids(ids)
        return torch.as_tensor(self._assign(raw).reshape(tuple(raw.shape)))

    def pull(self, ids):
        return super().pull(self.slots(ids))

    def push(self, ids, grads):
        self._push_count += 1
        super().push(torch.as_tensor(self._assign(ids)), grads)

    @torch.no_grad()
    def shrink(self, ttl):
        """Evict rows untouched for ``ttl`` pushes (reference:
        Table::Shrink).  Freed slots are re-initialized and reused."""
        cutoff = self._push_count - int(ttl)
        dead = [raw for raw, slot in self._slot_of.items()
                if self._last_touch[slot] < cutoff]
        if not dead:
            return 0
        slots = torch.as_tensor(np.asarray(
            [self._slot_of.pop(raw) for raw in dead], np.int64))
        # evicted slots are RE-INITIALIZED (not zeroed): the next id to
        # reuse the slot must look freshly created, like the reference's
        # first-access init after a Shrink
        fresh = self._init_rows(slots.numel())
        for lo, hi, dev, sh in self._shards:
            pos = ((slots >= lo) & (slots < hi)).nonzero().reshape(-1)
            if not pos.numel():
                continue
            local = (slots.index_select(0, pos) - lo).to(dev)
            sh["weight"].index_copy_(0, local,
                                     fresh.index_select(0, pos).to(dev))
            for k in ("m", "v", "t"):
                if k in sh:
                    sh[k].index_fill_(0, local, 0)
        self._free.extend(slots.tolist())
        return len(dead)

    # -- persistence: parent shard files + the id map --------------------
    def save(self, dirname, num_shards=None):
        super().save(dirname, num_shards)
        with open(os.path.join(dirname, f"{self.name}.idmap"),
                  "wb") as f:
            pickle.dump({"slot_of": self._slot_of,
                         "push_count": self._push_count,
                         "last_touch": self._last_touch,
                         "max_rows": self.max_rows}, f, protocol=4)

    def load(self, dirname):
        """Restore slab + id map.  The slab takes the stored capacity
        directly and the saved max_rows wins over the constructed one."""
        with open(os.path.join(dirname, f"{self.name}.idmap"),
                  "rb") as f:
            m = pickle.load(f)
        self.max_rows = m["max_rows"]
        with open(os.path.join(dirname, f"{self.name}.meta"), "rb") as f:
            self.rows = int(pickle.load(f)["rows"])
        super().load(dirname)
        self._slot_of = {int(k): int(v) for k, v in m["slot_of"].items()}
        self._push_count = int(m["push_count"])
        self._last_touch = np.asarray(m["last_touch"], np.int64)
        used = set(self._slot_of.values())
        self._free = [s for s in range(self.rows - 1, -1, -1)
                      if s not in used]


class GeoSparseTable(HashedSparseTable):
    """Geo-async sparse table (reference: ``table/sparse_geo_table.h`` +
    ``depends/geo_recorder.h:60`` + the trainer-side GeoCommunicator in
    ``operators/distributed/communicator.cc``): workers train on LOCAL
    row copies and flush interval-accumulated deltas, the table SUMS raw
    deltas (the geo SSUM accessor — no optimizer rule on the server),
    and a per-trainer recorder tracks which ids each worker must refresh
    (``pull_geo_param``)."""

    def __init__(self, name, dim, trainer_num=1, **kwargs):
        super().__init__(name, dim, **kwargs)
        self.trainer_num = int(trainer_num)
        self._pending = [set() for _ in range(self.trainer_num)]

    @torch.no_grad()
    def apply_deltas(self, ids, deltas):
        """Raw scatter-add of geo deltas — the SSUM merge rule (no
        optimizer state touched)."""
        slots = torch.as_tensor(self._assign(ids))
        d = (deltas if isinstance(deltas, torch.Tensor)
             else torch.as_tensor(np.asarray(deltas))).reshape(-1, self.dim)
        for lo, hi, dev, sh in self._shards:
            pos = ((slots >= lo) & (slots < hi)).nonzero().reshape(-1)
            if pos.numel():
                sh["weight"].index_add_(
                    0, (slots.index_select(0, pos) - lo).to(dev),
                    d.index_select(0, pos.to(d.device)).to(
                        dev, torch.float32))

    def geo_push(self, trainer_id, ids, deltas):
        """A worker's interval flush: merge deltas + record the ids for
        every OTHER trainer (geo_recorder.h Update)."""
        self._push_count += 1
        self.apply_deltas(ids, deltas)
        for t in range(self.trainer_num):
            if t != trainer_id:
                self._pending[t].update(
                    int(i) for i in _ids(ids).reshape(-1).tolist())

    def pull_geo_param(self, trainer_id):
        """GetAndClear (sparse_geo_table.cc:20): the ids other trainers
        changed since this trainer's last refresh, with fresh values."""
        ids = np.asarray(sorted(self._pending[trainer_id]), np.int64)
        self._pending[trainer_id].clear()
        if ids.size == 0:
            return ids, None
        return ids, self.pull(ids)

    # -- persistence: parent artifacts + the per-trainer refresh queues
    def save(self, dirname, num_shards=None):
        super().save(dirname, num_shards)
        with open(os.path.join(dirname, f"{self.name}.geo"), "wb") as f:
            pickle.dump({"trainer_num": self.trainer_num,
                         "pending": [sorted(s) for s in self._pending]},
                        f, protocol=4)

    def load(self, dirname):
        super().load(dirname)
        with open(os.path.join(dirname, f"{self.name}.geo"), "rb") as f:
            m = pickle.load(f)
        self.trainer_num = int(m["trainer_num"])
        self._pending = [set(s) for s in m["pending"]]


class GeoWorkerTable:
    """Trainer-side geo view (reference GeoCommunicator semantics): pulls
    populate a local replica, pushes apply plain SGD locally, and every
    ``geo_need_push_nums`` pushes the accumulated delta ``(local - base)
    / trainer_num`` is flushed to the GeoSparseTable, followed by a
    refresh of rows other trainers changed (communicator.cc geo mode:
    send_threshold + recv per interval)."""

    def __init__(self, table: GeoSparseTable, trainer_id,
                 geo_need_push_nums=10, lr=None):
        self.table = table
        self.trainer_id = int(trainer_id)
        self.interval = int(geo_need_push_nums)
        self.lr = float(lr if lr is not None else table.lr)
        self._local = {}   # id -> np row (trained locally)
        self._base = {}    # id -> np row at last sync
        self._pushes = 0

    def _ensure(self, ids_np):
        missing = [i for i in ids_np.tolist() if i not in self._local]
        if missing:
            rows = _host(self.table.pull(np.asarray(missing, np.int64)))
            for i, r in zip(missing, rows):
                self._local[i] = r.astype(np.float32).copy()
                self._base[i] = r.astype(np.float32).copy()

    def pull(self, ids):
        ids_np = _ids(ids).cpu().numpy().astype(np.int64).reshape(-1)
        self._ensure(ids_np)
        return torch.as_tensor(np.stack([self._local[i]
                                         for i in ids_np.tolist()]))

    def push(self, ids, grads):
        ids_np = _ids(ids).cpu().numpy().astype(np.int64).reshape(-1)
        g = (_host(grads) if isinstance(grads, torch.Tensor)
             else np.asarray(grads, np.float32)).reshape(len(ids_np), -1)
        self._ensure(ids_np)
        for i, gi in zip(ids_np.tolist(), g):
            self._local[i] = self._local[i] - self.lr * gi
        self._pushes += 1
        if self._pushes % self.interval == 0:
            self.flush()

    def flush(self):
        """Interval delta push + cross-trainer refresh."""
        ids = np.asarray(sorted(self._local), np.int64)
        if ids.size:
            deltas = np.stack(
                [(self._local[i] - self._base[i])
                 / self.table.trainer_num for i in ids.tolist()])
            touched = np.abs(deltas).sum(axis=1) > 0
            if touched.any():
                self.table.geo_push(self.trainer_id, ids[touched],
                                    deltas[touched])
            for i in ids.tolist():
                self._base[i] = self._local[i].copy()
        fresh_ids, fresh = self.table.pull_geo_param(self.trainer_id)
        if fresh is not None:
            rows = _host(fresh)
            for i, r in zip(fresh_ids.tolist(), rows):
                self._local[i] = r.astype(np.float32).copy()
                self._base[i] = r.astype(np.float32).copy()


class DistributedEmbedding:
    """Trainer-side embedding over a SparseTable (reference:
    ``distributed_lookup_table_op`` + communicator push/pull).  Forward
    pulls; ``apply_gradients`` pushes — the explicit analogue of the
    async communicator's send queue."""

    def __init__(self, table: SparseTable):
        self.table = table
        self._last_ids = None

    def __call__(self, ids):
        self._last_ids = ids
        return self.table.pull(ids)

    def apply_gradients(self, grads, ids=None):
        ids = ids if ids is not None else self._last_ids
        self.table.push(ids, grads)


class TheOnePS:
    """Runtime facade (reference: fleet/runtime/the_one_ps.py:378).

    Real: the table registry, warm-start load from sharded files
    (``init_server(dirname)``), sharded persistence
    (``save_persistables``), and a job-wide ``barrier``.  No-ops:
    ``run_server`` / ``init_worker`` / ``stop_worker`` — there are no
    server processes (tables live sharded on the mesh and pull/push are
    tensor ops).  The call-sequence contract is kept so PS-style
    training scripts run unchanged."""

    def __init__(self):
        self.tables = {}

    def barrier(self):
        """Block until every process reaches this point (reference:
        BarrierTable / fleet.barrier)."""
        process.barrier(key=("the_one_ps",))

    def create_table(self, name, rows, dim, **kwargs):
        """rows=None creates an unbounded HashedSparseTable (reference:
        MemorySparseTable); an int keeps the fixed-capacity fast path."""
        if rows is None:
            table = HashedSparseTable(name, dim, **kwargs)
        else:
            table = SparseTable(name, rows, dim, **kwargs)
        self.tables[name] = table
        return table

    # -- server contract -------------------------------------------------
    def init_server(self, dirname=None, var_names=None, **kwargs):
        if dirname:
            for name, table in self.tables.items():
                if any(os.path.exists(os.path.join(dirname, f"{name}{ext}"))
                       for ext in (".meta", ".table")):
                    table.load(dirname)

    def run_server(self):
        pass  # nothing to serve: tables live on the mesh

    def init_worker(self):
        pass

    def stop_worker(self):
        pass

    # -- persistence ------------------------------------------------------
    def save_persistables(self, executor=None, dirname=None, **kwargs):
        for table in self.tables.values():
            table.save(dirname)

    def save_inference_model(self, *args, **kwargs):
        self.save_persistables(*args, **kwargs)


_runtime = TheOnePS()


def get_ps_runtime():
    return _runtime

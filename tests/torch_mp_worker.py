"""Worker for the port's multi-process runs: every training layout over a
mesh that spans processes, in turn, plus the multi-process forms beside
them (the reference pattern of test_collective_base.py /
test_dist_base.py:668 — each process runs the same script and prints
its results for the parent to compare).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --devices_per_proc 2 tests/torch_mp_worker.py --size small

``--size small`` runs the layouts at the JAX workers' sizes
(``tests/multiprocess_worker*.py``) on CPU ranks, with weights made from
numpy seeds (``small_weights``), and the checks of the other
multi-process forms; ``--size gpt2-medium`` trains ``gpt2-medium`` from
seed 0 at B=4 x S=1024 in bf16 O1 (the flash kernels) with AdamW and
reports each layout's step time, memory, the bytes that crossed
processes and the time under the ``process.*`` profiler labels.  Run
without the launcher (one process) it runs the same layouts over
``--ranks`` ranks of this process on one device: the one-process
reference.  Each result is a line ``RESULT <tag> <json>``.
"""
import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SMALL_LAYOUTS = ("dp", "zero2", "mp", "pp_gpipe", "pp_1f1b")
GPT_LAYOUTS = ("dp2", "zero2", "mp2", "pp2_gpipe", "pp2_1f1b")
SMALL_STEPS = {"dp": 5, "zero2": 5, "mp": 5, "pp_gpipe": 4, "pp_1f1b": 4}


def emit(tag, value):
    print(f"RESULT {tag} "
          f"{json.dumps(value, default=lambda o: np.asarray(o).tolist())}",
          flush=True)


# -- the small layouts (the JAX workers' models) ---------------------------
def small_data():
    rng = np.random.RandomState(0)
    x = rng.rand(16, 8).astype("float32")
    w_true = rng.rand(8, 1).astype("float32")
    return x, x @ w_true


SMALL_SHAPES = {
    "dp": {"weight": (8, 1), "bias": (1,)},
    "zero2": {"0.weight": (8, 16), "0.bias": (16,), "2.weight": (16, 1),
              "2.bias": (1,)},
    "mp": {"0.weight": (8, 16), "0.bias": (16,), "2.weight": (16, 1),
           "2.bias": (1,)},
    "pp": {"pre.weight": (8, 8), "pre.bias": (8,),
           "blocks.0.0.weight": (8, 8), "blocks.0.0.bias": (8,),
           "blocks.1.0.weight": (8, 8), "blocks.1.0.bias": (8,),
           "post.weight": (8, 1), "post.bias": (1,)},
}


def small_weights(kind, seed=0):
    """The layout's weights in the JAX (``[in, out]``) layout, from a numpy
    seed; the parent test loads the same into the JAX models."""
    rng = np.random.RandomState(seed)
    return {k: (rng.uniform(-0.5, 0.5, shape) / np.sqrt(shape[0]))
            .astype("float32")
            for k, shape in sorted(SMALL_SHAPES[kind].items())}


def small_model(kind):
    from paddle_tpu_torch.convert import load_paddle_tpu_state
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    from paddle_tpu_torch.distributed.sharding import (ColumnParallelLinear,
                                                       RowParallelLinear)
    nn = torch.nn
    with torch.device("cpu"):
        if kind == "dp":
            net = nn.Linear(8, 1)
        elif kind == "zero2":
            net = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 1))
        elif kind == "mp":
            net = nn.Sequential(
                ColumnParallelLinear(8, 16, gather_output=False), nn.Tanh(),
                RowParallelLinear(16, 1, input_is_parallel=True))
        else:
            net = PipelineLayer(
                pre=nn.Linear(8, 8),
                blocks=[nn.Sequential(nn.Linear(8, 8), nn.Tanh())
                        for _ in range(2)],
                post=nn.Linear(8, 1))
    return load_paddle_tpu_state(net, small_weights(kind[:2] if
                                                    kind.startswith("pp")
                                                    else kind))


def local_rows(a, mesh):
    """This process's shard of the global batch ``a`` along the data axes:
    the chunks of the distinct data indices its ranks hold, in order."""
    from paddle_tpu_torch.distributed import process
    from paddle_tpu_torch.distributed.mesh import DATA_AXES, data_axes_size
    from paddle_tpu_torch.distributed.sharding import _chunk_index
    if process.count() == 1:
        return a
    n = data_axes_size(mesh)
    idx = sorted({_chunk_index(mesh.coords(r), DATA_AXES, mesh)
                  for r in mesh.local_ranks})
    chunks = np.split(np.asarray(a), n)
    return np.concatenate([chunks[i] for i in idx])


def mesh_for(kind, ranks, device):
    from paddle_tpu_torch.distributed import build_mesh, process
    shape = {"dp": dict(dp=ranks), "zero2": dict(sharding=ranks),
             "mp": dict(mp=ranks), "dp2": dict(dp=ranks),
             "mp2": dict(mp=ranks)}.get(kind)
    if shape is None:       # a pipeline
        shape = dict(dp=ranks // 2, pp=2)
    if process.count() == 1:
        return build_mesh(devices=[device] * ranks, **shape)
    devs = process.devices()
    if shape.get("dp", 1) > 1 and "pp" in shape:
        # each pp pair is (process 0's device, process 1's): the stage
        # boundary crosses processes, as tests/multiprocess_worker.py
        # lays its devices
        half = len(devs) // 2
        devs = [d for pair in zip(devs[:half], devs[half:]) for d in pair]
    return build_mesh(devices=devs, **shape)


def strategy_for(kind, micro=2):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    s = DistributedStrategy()
    if kind == "zero2":
        s.sharding = True
        s.sharding_configs.update({"stage": 2})
    if "pp" in kind:
        s.pipeline = True
        s.pipeline_configs["accumulate_steps"] = micro
        s.pipeline_configs["schedule_mode"] = ("1F1B" if "1f1b" in kind
                                               else "F-then-B")
    return s


def small_layout(kind, ranks):
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.parallel import TrainStep
    x, y = small_data()
    mesh = mesh_for(kind, ranks, "cpu")
    net = small_model(kind)
    if kind == "zero2":
        opt = topt.Adam(learning_rate=0.05, parameters=net.parameters(),
                        device="cpu")
    else:
        lr = 0.05 if kind.startswith("pp") else 0.1
        opt = topt.SGD(learning_rate=lr, parameters=net.parameters(),
                       device="cpu")
    step = TrainStep(net, opt, loss_fn=torch.nn.MSELoss(),
                     strategy=strategy_for(kind), mesh=mesh)
    if kind in ("dp", "zero2"):
        feed = [local_rows(x, mesh)], [local_rows(y, mesh)]
    else:
        feed = [x], [y]
    return [float(step.step(*feed)) for _ in range(SMALL_STEPS[kind])]


def small_checks(ranks):
    """The multi-process forms beside training (each result a line)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, process
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.fleet import metrics as fleet_util
    rank = dist.get_rank()
    mesh = dist.build_mesh(dp=ranks)
    dist.set_mesh(mesh)
    local = np.full((ranks // process.count(), 1), float(rank + 1),
                    np.float32)
    glob = mesh_mod.host_local_to_global(local, mesh, "dp", None)
    out = collective.parallel_region(
        lambda t: collective.all_reduce(t, group="dp"), "dp", mesh)(glob)
    emit(f"psum {rank}", [float(t.reshape(-1)[0]) for t in
                          out.pieces.values()])
    # p2p_shift across the processes, forward and backward, and the
    # exchanges that cross as every part gathered (broadcast, scatter,
    # alltoall)
    xs = np.arange(ranks, dtype=np.float32)

    def region(fn):
        out = collective.parallel_region(fn, "dp", mesh)(xs)
        return {r: t.tolist() for r, t in out.pieces.items()}

    leaves = {r: torch.tensor([float(r)], requires_grad=True)
              for r in mesh.local_ranks}
    shifted = collective.run_ranks(mesh, {
        r: (lambda r=r: collective.p2p_shift(leaves[r], axis="dp", shift=1))
        for r in leaves})
    sum((r + 1) * shifted[r].sum() for r in leaves).backward()
    emit(f"collectives {rank}", {
        "shift": {r: t.tolist() for r, t in shifted.items()},
        "shift_grad": {r: t.grad.tolist() for r, t in leaves.items()},
        "broadcast": region(lambda x: collective.broadcast(x.clone(),
                                                           src=3)),
        "scatter": region(lambda x: collective.scatter(
            x.clone(), [torch.full((1,), 10.0 + i) for i in range(ranks)],
            src=0)),
        "alltoall": region(lambda x: torch.cat(collective.alltoall(
            [x + 10 * i for i in range(ranks)], [])))})
    # the multi-process feed: each process's pieces, by rank
    x, _ = small_data()
    h = mesh_mod.host_local_to_global(local_rows(x, mesh), mesh)
    g = mesh_mod.global_from_replicated(x, mesh)
    emit(f"feed {rank}", {
        "shape": list(h.shape), "ranks": sorted(h.pieces),
        "host_local": {r: t.tolist() for r, t in h.pieces.items()},
        "replicated": {r: t.tolist() for r, t in g.pieces.items()}})
    try:
        mesh_mod.host_local_to_global(np.zeros((3, 2), np.float32), mesh)
        emit(f"feed_odd {rank}", "no error")
    except ValueError as e:
        emit(f"feed_odd {rank}", str(e))
    # fleet.util and the metrics, over this process's numbers
    u = fleet_util.UtilBase()
    vals = np.arange(3, dtype=np.float64) + 10 * rank
    emit(f"util {rank}", {
        "sum": u.all_reduce(vals, "sum").tolist(),
        "max": u.all_reduce(vals, "max").tolist(),
        "min": u.all_reduce(vals, "min").tolist(),
        "gather": u.all_gather({"r": rank}),
        "shard": u.get_file_shard([f"f{i}" for i in range(5)]),
        "metric_sum": fleet_util.sum(vals),
        "acc": fleet_util.acc(3 + rank, 10),
        "mae": fleet_util.mae(np.array([0.5, 1.0 + rank]), 4),
        "rmse": fleet_util.rmse(np.array([1.0, 2.0 * rank]), 4),
        "auc": fleet_util.auc(np.array([1.0, 2.0, 3.0 + rank]),
                              np.array([3.0 - rank, 2.0, 1.0]))})
    u.barrier()
    # a pipeline fed different batches by its processes refuses it
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.parallel import TrainStep
    x, y = small_data()
    net = small_model("pp_gpipe")
    step = TrainStep(net, topt.SGD(learning_rate=0.05,
                                   parameters=net.parameters(),
                                   device="cpu"),
                     loss_fn=torch.nn.MSELoss(),
                     strategy=strategy_for("pp_gpipe"),
                     mesh=mesh_for("pp_gpipe", ranks, "cpu"))
    try:
        step.step([x + rank], [y])
        emit(f"digest {rank}", "no error")
    except ValueError as e:
        emit(f"digest {rank}", str(e))
    # a rank's random stream does not depend on the process running it:
    # process 1's own generator is moved on first
    torch.manual_seed(123)
    if rank == 1:
        torch.rand(5)
    draws = collective.run_ranks(mesh, {r: (lambda: float(torch.rand(1)))
                                        for r in range(ranks)})
    emit(f"rng {rank}", draws)
    # spawn calls func here
    called = []
    dist.spawn(called.append, args=(rank,))
    emit(f"spawn {rank}", called)


def global_shuffle_check(path):
    """Every process loads the same records; global_shuffle gives each
    its share of one permutation."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.io.native_dataset import InMemoryDataset
    rank = dist.get_rank()
    # one data-parallel index a process: get_world_size() is 2
    dist.set_mesh(dist.build_mesh(dp=2, mp=2))

    class Var:
        def __init__(self, name, shape, dtype):
            self.name, self.shape, self.dtype = name, shape, dtype

    ds = InMemoryDataset()
    ds.set_batch_size(1)
    ds.set_use_var([Var("x", [-1, 1], "int64")])
    ds.set_filelist([path])
    ds.load_into_memory()
    ds.global_shuffle()
    emit(f"shuffle {rank}", sorted(int(b[0].reshape(-1)[0]) for b in ds))


def order_mismatch_check():
    """Collectives called in a different order by the processes raise
    (the header check) instead of hanging."""
    from paddle_tpu_torch.distributed import process
    rank = process.index()
    t = torch.ones(4)
    calls = [lambda: process.all_reduce(t, name="all_reduce"),
             lambda: process.all_gather(t, name="all_gather")]
    if rank == 1:
        calls.reverse()
    try:
        for c in calls:
            c()
        emit(f"order {rank}", "no error")
    except RuntimeError as e:
        emit(f"order {rank}", str(e))


# -- gpt2-medium on the card ---------------------------------------------
def gpt_model(kind, layers):
    from paddle_tpu_torch.models import GPTModel, gpt_pipe_model
    if "pp" in kind:
        return gpt_pipe_model("gpt2-medium", dropout=0.0, seed=0,
                              num_layers=layers)
    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0,
                                 fused_loss=True, num_layers=layers)
    return model.to_tensor_parallel() if kind == "mp2" else model


class F32Criterion(torch.nn.Module):
    """``GPTPretrainingCriterion`` over the logits in f32: under O1 a
    pipeline's head gives bf16 logits, and the loss of each micro-batch
    (1F1B) and of the whole batch (GPipe) would round apart in bf16."""

    def forward(self, logits, labels):
        from paddle_tpu_torch.models import GPTPretrainingCriterion
        return GPTPretrainingCriterion()(logits.float(), labels)


def gpt_layout(kind, ranks, layers, batch, seq, steps):
    from paddle_tpu_torch.distributed import process
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep
    dev = torch.device("cuda", torch.cuda.current_device())
    model = gpt_model(kind, layers)
    vocab = 50257
    ids = np.random.RandomState(0).randint(0, vocab, (batch, seq + 1))
    x, y = ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)
    mesh = mesh_for(kind, ranks, dev)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    step = TrainStep(model, opt, strategy=strategy_for(kind),
                     loss_fn=F32Criterion() if "pp" in kind else None,
                     mesh=mesh, amp_level="O1")
    if kind in ("dp2", "zero2"):
        feed = [torch.as_tensor(local_rows(x, mesh)),
                torch.as_tensor(local_rows(y, mesh))]
    else:
        feed = [torch.as_tensor(x), torch.as_tensor(y)]
    if "pp" in kind:
        feed = ([feed[0]], [feed[1]])
    else:
        feed = (feed, [])
    for op in fa.KERNEL_OPS.values():
        op.launches = 0
    gc.collect()                # an earlier layout's cycles, off the peak
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step.step(*feed))]          # the warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step.step(*feed))
    losses = [float(v) for v in losses]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: op.launches for n, op in fa.KERNEL_OPS.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"losses": losses, "ms_per_step": wall / steps * 1e3,
           "tokens_per_s": batch * seq * steps / wall,
           "peak_gb": peak, "launches": launches, "steps": steps + 1,
           "layers": layers}
    if process.count() > 1:
        process.stats(reset=True)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step.step(*feed)
            torch.cuda.synchronize()
        st = process.stats(reset=True)
        label_ms = sum(e.cpu_time_total for e in prof.key_averages()
                       if e.key.startswith("process.")) / 1e3
        out.update(cross_bytes=sum(v["bytes"] for v in st.values()),
                   staged_bytes=sum(v["staged_bytes"] for v in st.values()),
                   cross_calls=sum(v["calls"] for v in st.values()),
                   process_label_ms=label_ms,
                   cross_by_kind={k: v["bytes"] for k, v in st.items()})
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="small",
                    choices=("small", "gpt2-medium"))
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the mesh (default every process's "
                         "devices; alone, 4 small / 2 gpt2-medium)")
    ap.add_argument("--layouts", default=None)
    ap.add_argument("--layers", default="24,24,8,8,8",
                    help="gpt2-medium depth of each layout, in order")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--shuffle-file", default=None)
    args = ap.parse_args()
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import process
    if int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) > 1:
        dist.init_parallel_env()
    rank = dist.get_rank()
    if args.size == "small":
        layouts = SMALL_LAYOUTS
        ranks = args.ranks or (len(process.devices())
                               if process.count() > 1 else 4)
    else:
        from paddle_tpu_torch.nn.functional import attention
        attention.FLASH_MIN_SEQ = 1024
        layouts = GPT_LAYOUTS
        ranks = args.ranks or (len(process.devices())
                               if process.count() > 1 else 2)
    if args.layouts:
        layouts = args.layouts.split(",")
    emit(f"world {rank}", {"processes": process.count(),
                           "backend": process.backend(), "ranks": ranks})
    depth = dict(zip(GPT_LAYOUTS, (int(v) for v in args.layers.split(","))))
    for kind in layouts:
        t0 = time.perf_counter()
        if args.size == "small":
            res = {"losses": small_layout(kind, ranks)}
        else:
            res = gpt_layout(kind, ranks, depth[kind], 4, 1024, args.steps)
        res["wall_s"] = time.perf_counter() - t0
        emit(f"{kind} {rank}", res)
    if args.size == "small" and process.count() > 1:
        small_checks(ranks)
        if args.shuffle_file:
            global_shuffle_check(args.shuffle_file)
        order_mismatch_check()
    emit(f"done {rank}", True)


if __name__ == "__main__":
    main()

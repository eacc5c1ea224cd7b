"""The port's pipeline schedules (``parallel/pipeline.py``) held to the
JAX package's.

``gpt_pipe_model("tiny")`` (2 blocks, dropout 0) over ``pp=2`` with
``accumulate_steps=4``, bridged from the JAX package's, three
``Momentum`` steps in fp32 on the same batch: GPipe with and without
``strategy.recompute`` and 1F1B, losses at rtol 1e-4, parameters at atol
1e-5 / rtol 1e-4 against the JAX ``TrainStep`` over ``build_mesh(pp=2)``.
Beside them, the edges the JAX package's tests hold
(tests/test_pipeline_1f1b.py): BN running statistics advance under both
schedules and ``sync_to_layer`` writes them back; a block whose training
forward reads a buffer is refused under 1F1B and a BN block passes; 1F1B
takes exactly one labels array; the blocks must divide over pp.  Also:
the weight bridge loads a JAX ``PipelineLayer``'s state;
``gpt_pipe_model`` draws ``GPTModel.from_config``'s weights from the same
seed; and a train state saved under pp=2 continues exactly.

Beside other axes, against the JAX step on the same mesh (which runs
the whole batch on every coordinate): GPipe with and without recompute
and 1F1B over ``dp=2 x pp=2``, ``dp=2 x pp=4`` (JAX's ``pp_mesh``) and
``dp=2 x mp=2 x pp=2`` (JAX's ``hybrid_mesh``, with a vocab-parallel
embedding and head around dense blocks); a BN-block pipeline over
``dp=2 x pp=2`` whose running statistics equal JAX's; a masked token
mean over ``dp=2 x pp=2``, its ignored labels spread unevenly over the
data ranks; ``sp=2`` or ``ep=2`` beside pp=2 (replicas); micro-batches of one row over dp=2 (run by one pipeline);
blocks split over mp refused with JAX's ``ValueError``; and
``LarsMomentum``'s norms over the vocab-parallel ends' pieces equal the
whole parameter's.
"""
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet.meta_parallel import \
    PipelineLayer as JaxPipelineLayer
from paddle_tpu.distributed.fleet.strategy import \
    DistributedStrategy as JaxStrategy
from paddle_tpu.models import gpt_pipe_model as jax_pipe_model
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.parallel.train_step import TrainStep as JaxTrainStep
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import build_mesh
from paddle_tpu_torch.distributed.checkpoint import (load_train_state,
                                                     save_train_state)
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.fleet.meta_parallel import PipelineLayer
from paddle_tpu_torch.models import GPTModel, gpt_pipe_model
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
from paddle_tpu_torch.parallel import TrainStep

from torch_mesh_helpers import assert_params_close, bridge, meshes, run_both

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_process_mesh():
    from paddle_tpu.distributed import mesh as jmesh
    prev = jmesh.get_mesh()
    yield
    jmesh.set_mesh(prev)


def _pipe_strategy(cls, schedule, M=4, recompute=False):
    s = cls()
    s.pipeline = True
    s.pipeline_configs["accumulate_steps"] = M
    s.pipeline_configs["schedule_mode"] = schedule
    s.recompute = recompute
    return s


def _batch():
    ids = np.random.RandomState(0).randint(0, 128, (8, 17)).astype(np.int64)
    return ids[:, :-1], ids[:, 1:]


@pytest.mark.parametrize("schedule,recompute", [
    ("F-then-B", False), ("F-then-B", True), ("1F1B", False)])
def test_gpt_pipeline_matches_jax(schedule, recompute):
    paddle.seed(0)
    jm = jax_pipe_model("tiny", dropout=0.0)
    tm = bridge(jm, gpt_pipe_model("tiny", device="cpu", dropout=0.0))
    jmesh_, tmesh_ = meshes(pp=2)
    jst = JaxTrainStep(
        jm, jopt.Momentum(learning_rate=0.1, parameters=jm.parameters()),
        loss_fn=JaxCriterion(), mesh=jmesh_,
        strategy=_pipe_strategy(JaxStrategy, schedule, recompute=recompute))
    tst = TrainStep(
        tm, topt.Momentum(learning_rate=0.1, parameters=tm.parameters(),
                          device="cpu"),
        loss_fn=GPTPretrainingCriterion(), mesh=tmesh_,
        strategy=_pipe_strategy(DistributedStrategy, schedule,
                                recompute=recompute))
    assert tst.is_pipeline and tst.engine.bps == 1
    x, y = _batch()
    run_both(jst, tst, [x], [y])
    # 1F1B holds at most 2P - 1 = 3 of the M = 4 inputs a stage
    assert tst.engine.max_stored_inputs == (3 if schedule == "1F1B" else 0)
    jst.sync_to_layer()
    tst.sync_to_layer()
    assert_params_close(jm, tm)


def test_jax_pipeline_state_bridges_and_seeds_match_from_config():
    """The bridge loads a JAX ``PipelineLayer`` by name (same forward);
    ``gpt_pipe_model`` and ``from_config`` draw the same weights."""
    paddle.seed(1)
    jm = jax_pipe_model("tiny", dropout=0.0)
    tm = bridge(jm, gpt_pipe_model("tiny", device="cpu", dropout=0.0))
    ids = np.random.RandomState(2).randint(0, 128, (2, 16))
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    np.testing.assert_allclose(tm(torch.tensor(ids)).detach().numpy(),
                               want, atol=1e-5)
    pipe = gpt_pipe_model("tiny", device="cpu", seed=3)
    dense = GPTModel.from_config("tiny", device="cpu", seed=3)
    names = {re.sub(r"^head\.", "post.",
                    re.sub(r"^embeddings\.", "pre.", k)): v
             for k, v in dense.state_dict().items()}
    for k, v in pipe.state_dict().items():
        assert torch.equal(v, names[k]), k


class _BNBlock(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(6, 6)
        self.bn = torch.nn.BatchNorm1d(6)

    def forward(self, x):
        return self.bn(self.fc(x))


class _BufReadingBlock(torch.nn.Module):
    """A training forward that READS a buffer value."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(6, 6)
        self.register_buffer("scale_buf", torch.ones(6))

    def forward(self, x):
        return self.fc(x) * self.scale_buf


def _bn_step(block_cls, schedule, M=2, recompute=False, mesh=None):
    torch.manual_seed(21)
    blocks = [block_cls() for _ in range(4)]
    pipe = PipelineLayer(pre=None, blocks=blocks, post=torch.nn.Linear(6, 2))
    st = TrainStep(pipe, topt.SGD(
        learning_rate=0.01, parameters=pipe.parameters(), device="cpu"),
        loss_fn=torch.nn.MSELoss(),
        strategy=_pipe_strategy(DistributedStrategy, schedule, M=M,
                                recompute=recompute),
        mesh=mesh or build_mesh(pp=4, devices=["cpu"] * 4))
    return pipe, blocks, st


@pytest.mark.parametrize("schedule,recompute", [
    ("F-then-B", False), ("F-then-B", True), ("1F1B", False)])
def test_bn_stats_update_once_per_micro_batch(schedule, recompute):
    """Two micro-batches advance every block's statistics twice, never in
    a recomputation; the first block's running mean equals two momentum-
    0.1 updates toward its micro-batches' means."""
    _, blocks, st = _bn_step(_BNBlock, schedule, recompute=recompute)
    rs = np.random.RandomState(3)
    x = rs.rand(8, 6).astype(np.float32) * 4 + 2
    y = rs.rand(8, 2).astype(np.float32)
    with torch.no_grad():
        h = blocks[0].fc(torch.tensor(x))
    want = torch.zeros(6)
    for part in h.chunk(2):
        want = 0.9 * want + 0.1 * part.mean(0)
    st.step([x], [y])
    st.sync_to_layer()
    for blk in blocks:
        assert int(blk.bn.num_batches_tracked) == 2
    torch.testing.assert_close(blocks[0].bn.running_mean, want)


def test_sync_to_layer_restores_buffers():
    pipe, blocks, st = _bn_step(_BNBlock, "F-then-B")
    rs = np.random.RandomState(4)
    st.step([rs.rand(8, 6).astype(np.float32) + 3],
            [rs.rand(8, 2).astype(np.float32)])
    assert float(blocks[0].bn.running_mean.abs().sum()) == 0.0
    st.sync_to_layer()
    assert float(blocks[0].bn.running_mean.abs().sum()) > 0.0


def test_buffer_reading_forward_is_refused_under_1f1b():
    _, _, st = _bn_step(_BufReadingBlock, "1F1B")
    rs = np.random.RandomState(3)
    with pytest.raises(NotImplementedError, match="reads buffer"):
        st.step([rs.rand(8, 6).astype(np.float32)],
                [rs.rand(8, 2).astype(np.float32)])


def test_bn_block_passes_the_1f1b_guard():
    _, _, st = _bn_step(_BNBlock, "1F1B")
    rs = np.random.RandomState(3)
    loss = st.step([rs.rand(8, 6).astype(np.float32)],
                   [rs.rand(8, 2).astype(np.float32)])
    assert np.isfinite(float(loss))


def test_1f1b_takes_one_labels_array_and_blocks_divide_pp():
    _, _, st = _bn_step(_BNBlock, "1F1B")
    x = np.zeros((8, 6), np.float32)
    with pytest.raises(ValueError, match="exactly one labels array"):
        st.step([x], [x[:, :2], x[:, :2]])
    torch.manual_seed(0)
    three = PipelineLayer(blocks=[_BNBlock() for _ in range(3)])
    with pytest.raises(ValueError, match="must divide pp"):
        TrainStep(three, topt.SGD(parameters=three.parameters(),
                                  device="cpu"),
                  mesh=build_mesh(pp=2, devices=["cpu"] * 2))
    # beside data parallelism too, where the pipeline now trains
    # (test_gpt_pipeline_beside_other_axes_matches_jax)
    with pytest.raises(ValueError, match="must divide pp"):
        TrainStep(three, topt.SGD(parameters=three.parameters(),
                                  device="cpu"),
                  mesh=build_mesh(dp=2, pp=2, devices=["cpu"] * 4))
    _, _, st = _bn_step(_BNBlock, "1F1B",
                        mesh=build_mesh(dp=2, pp=4, devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="exactly one labels array"):
        st.step([x], [x[:, :2], x[:, :2]])


def test_stacked_block_params_round_trip():
    """The JAX package's stacked form of identical blocks and back."""
    from paddle_tpu_torch.parallel.pipeline import (stack_block_buffers,
                                                    stack_block_params,
                                                    unstack_block_buffers,
                                                    unstack_block_params)
    torch.manual_seed(0)
    src = [_BNBlock() for _ in range(3)]
    dst = [_BNBlock() for _ in range(3)]
    for b in src:
        b.bn.running_mean.uniform_()
    names, stacked = stack_block_params(src)
    assert stacked["fc.weight"].shape == (3, 6, 6)
    unstack_block_params(dst, names, stacked)
    bnames, bstacked = stack_block_buffers(src)
    unstack_block_buffers(dst, bnames, bstacked)
    for a, b in zip(src, dst):
        for (n, t), u in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(t, u), n


def test_train_state_round_trip_under_pp2(tmp_path):
    x, y = _batch()

    def make():
        tm = gpt_pipe_model("tiny", device="cpu", dropout=0.0, num_layers=4)
        return TrainStep(
            tm, topt.AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                           device="cpu"),
            loss_fn=GPTPretrainingCriterion(),
            mesh=build_mesh(pp=2, devices=["cpu"] * 2),
            strategy=_pipe_strategy(DistributedStrategy, "1F1B")), tm

    a, am = make()
    a.step([x], [y])
    want = float(a.step([x], [y]))
    a.sync_to_layer()
    b, _ = make()
    b.step([x], [y])
    save_train_state(b, str(tmp_path / "pp"))
    c, cm = make()
    load_train_state(c, str(tmp_path / "pp"))
    assert float(c.step([x], [y])) == pytest.approx(want, rel=1e-6)
    c.sync_to_layer()
    for (n, p), q in zip(am.named_parameters(), cm.parameters()):
        torch.testing.assert_close(q, p, atol=1e-7, rtol=1e-6, msg=n)


# -- beside other axes ------------------------------------------------------
SCHEDULES = [("F-then-B", False), ("F-then-B", True), ("1F1B", False)]
MESHES = {"dp2_pp2": dict(dp=2, pp=2), "dp2_pp4": dict(dp=2, pp=4),
          "dp2_mp2_pp2": dict(dp=2, mp=2, pp=2)}


def _tp_ends_pair(layers):
    """The tiny GPT pipeline with a vocab-parallel embedding and head
    around dense blocks, in both packages, on the same weights."""
    cfg = dict(tgpt.GPT_CONFIGS["tiny"])
    E, H, V, S = (cfg["hidden_size"], cfg["num_heads"], cfg["vocab_size"],
                  cfg["max_position"])
    jm = JaxPipelineLayer(
        pre=jgpt.GPTEmbeddings(V, E, S, 0.0, True),
        blocks=[jgpt.GPTBlock(E, H, 0.0, False) for _ in range(layers)],
        post=jgpt.GPTLMHead(E, V, True))
    tm = PipelineLayer(
        pre=tgpt.GPTEmbeddings(V, E, S, 0.0, True),
        blocks=[tgpt.GPTBlock(E, H, 0.0, False) for _ in range(layers)],
        post=tgpt.GPTLMHead(E, V, True))
    return jm, bridge(jm, tm)


def _pipe_pair(shape, schedule, recompute=False, tp_ends=False, M=4):
    paddle.seed(0)
    layers = 2 * shape["pp"]
    if tp_ends:
        jm, tm = _tp_ends_pair(layers)
    else:
        jm = jax_pipe_model("tiny", dropout=0.0, num_layers=layers)
        tm = bridge(jm, gpt_pipe_model("tiny", device="cpu", dropout=0.0,
                                       num_layers=layers))
    jmesh_, tmesh_ = meshes(**shape)
    jst = JaxTrainStep(
        jm, jopt.Momentum(learning_rate=0.1, parameters=jm.parameters()),
        loss_fn=JaxCriterion(), mesh=jmesh_,
        strategy=_pipe_strategy(JaxStrategy, schedule, M=M,
                                recompute=recompute))
    tst = TrainStep(
        tm, topt.Momentum(learning_rate=0.1, parameters=tm.parameters(),
                          device="cpu"),
        loss_fn=GPTPretrainingCriterion(), mesh=tmesh_,
        strategy=_pipe_strategy(DistributedStrategy, schedule, M=M,
                                recompute=recompute))
    return jm, tm, jst, tst


@pytest.mark.parametrize("schedule,recompute", SCHEDULES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gpt_pipeline_beside_other_axes_matches_jax(mesh, schedule,
                                                    recompute):
    """One pipeline a data rank, each running its rows of every
    micro-batch (8 rows, M=4: one row a data rank a micro-batch); over mp
    the embedding and head run on their mp group with their vocab
    pieces.  Losses and parameters equal JAX's, whose program runs the
    whole batch on every coordinate."""
    shape = MESHES[mesh]
    tp = "mp" in shape
    jm, tm, jst, tst = _pipe_pair(shape, schedule, recompute, tp_ends=tp)
    if tp:
        assert tst.param_specs["pre.word_embeddings.weight"] == ("mp", None)
        assert tst.param_specs["post.lm_head.weight"] == (None, "mp")
        assert tst.engine.end_mp == {"pre": 2, "post": 2}
    assert tst.engine.n_data == 2
    x, y = _batch()
    run_both(jst, tst, [x], [y])
    jst.sync_to_layer()
    tst.sync_to_layer()
    assert_params_close(jm, tm)


@pytest.mark.parametrize("axis", ["sp", "ep"])
def test_pipeline_beside_sp_or_ep_replicates_as_jax_does(axis):
    """JAX runs the same pipeline on every sp or ep coordinate (its
    ``gpt_pipe_model`` has no sp or ep layers); the port computes that
    replica once, and equals it."""
    jm, tm, jst, tst = _pipe_pair({axis: 2, "pp": 2}, "F-then-B")
    assert tst.engine.n_data == 1 and tst.engine.end_mp == {"pre": 1,
                                                           "post": 1}
    x, y = _batch()
    run_both(jst, tst, [x], [y])
    jst.sync_to_layer()
    tst.sync_to_layer()
    assert_params_close(jm, tm)


@pytest.mark.parametrize("schedule", ["F-then-B", "1F1B"])
def test_masked_token_mean_over_dp2_pp2_matches_jax(schedule):
    """Ignored labels spread unevenly over the data ranks and the
    micro-batches: the token mean is the whole batch's (GPipe) or the
    micro-batch's (1F1B), as JAX computes it."""
    jm, tm, jst, tst = _pipe_pair(dict(dp=2, pp=2), schedule)
    x, y = _batch()
    y = y.copy()
    y[0, ::2] = -100
    y[3, :13] = -100
    y[6, 5:] = -100
    run_both(jst, tst, [x], [y])
    jst.sync_to_layer()
    tst.sync_to_layer()
    assert_params_close(jm, tm)


class _JaxBNBlock(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(6, 6)
        self.bn = jnn.BatchNorm1D(6)

    def forward(self, x):
        return self.bn(self.fc(x))


class _PaddleBNBlock(torch.nn.Module):
    """``_JaxBNBlock`` in the port: Paddle's batch-norm conventions."""

    def __init__(self):
        super().__init__()
        from paddle_tpu_torch.nn.layer import BatchNorm1D
        self.fc = torch.nn.Linear(6, 6)
        with torch.device("cpu"):  # a Layer builds on the card by default
            self.bn = BatchNorm1D(6)

    def forward(self, x):
        return self.bn(self.fc(x))


@pytest.mark.parametrize("schedule", ["F-then-B", "1F1B"])
def test_bn_pipeline_over_dp2_pp2_matches_jax(schedule):
    """The JAX test_pipeline_1f1b.py BN pipeline: each data rank holds
    half of every micro-batch's rows, and the statistics are the whole
    micro-batch's, so losses, parameters and running statistics equal
    JAX's (atol 1e-6 / rtol 1e-5 for the statistics)."""
    paddle.seed(21)
    jm = JaxPipelineLayer(pre=None, blocks=[_JaxBNBlock() for _ in range(4)],
                          post=jnn.Linear(6, 2))
    tm = bridge(jm, PipelineLayer(
        pre=None, blocks=[_PaddleBNBlock() for _ in range(4)],
        post=torch.nn.Linear(6, 2)))
    jmesh_, tmesh_ = meshes(dp=2, pp=2)
    jst = JaxTrainStep(
        jm, jopt.SGD(learning_rate=0.01, parameters=jm.parameters()),
        loss_fn=jnn.MSELoss(), mesh=jmesh_,
        strategy=_pipe_strategy(JaxStrategy, schedule, M=2))
    tst = TrainStep(
        tm, topt.SGD(learning_rate=0.01, parameters=tm.parameters(),
                     device="cpu"),
        loss_fn=torch.nn.MSELoss(), mesh=tmesh_,
        strategy=_pipe_strategy(DistributedStrategy, schedule, M=2))
    rs = np.random.RandomState(3)
    x = rs.rand(8, 6).astype(np.float32) * 4 + 2
    y = rs.rand(8, 2).astype(np.float32)
    run_both(jst, tst, [x], [y])
    jst.sync_to_layer()
    tst.sync_to_layer()
    assert_params_close(jm, tm)
    jb = {n: np.asarray(b._data) for n, b in jm.named_buffers()
          if b is not None}
    tb = {n: b.numpy() for n, b in tm.named_buffers()}
    assert sorted(jb) == sorted(tb) and any("_mean" in n for n in jb)
    for n in jb:
        np.testing.assert_allclose(tb[n], jb[n], atol=1e-6, rtol=1e-5,
                                   err_msg=n)


def test_blocks_split_over_mp_are_refused_as_jax_refuses_them():
    """Blocks whose parameters are split over mp (``use_mp=True``) beside
    pp with mp=2: the JAX step's shard_map refuses their sharding
    constraint (ValueError), and so does the port."""
    x, y = _batch()
    paddle.seed(0)
    jm = jax_pipe_model("tiny", dropout=0.0, use_mp=True)
    tm = bridge(jm, gpt_pipe_model("tiny", device="cpu", dropout=0.0,
                                   use_mp=True))
    jmesh_, tmesh_ = meshes(mp=2, pp=2)
    jst = JaxTrainStep(
        jm, jopt.Momentum(learning_rate=0.1, parameters=jm.parameters()),
        loss_fn=JaxCriterion(), mesh=jmesh_,
        strategy=_pipe_strategy(JaxStrategy, "F-then-B"))
    with pytest.raises(ValueError):
        jst.step([x], [y])
    with pytest.raises(ValueError, match="split over mp"):
        TrainStep(tm, topt.Momentum(learning_rate=0.1,
                                    parameters=tm.parameters(),
                                    device="cpu"),
                  loss_fn=GPTPretrainingCriterion(), mesh=tmesh_,
                  strategy=_pipe_strategy(DistributedStrategy, "F-then-B"))


def test_lars_norms_cover_the_whole_vocab_parallel_parameter():
    """``LarsMomentum``'s local rate takes the norms of the whole
    parameter and gradient: over ``dp=2 x mp=2 x pp=2`` the vocab-parallel
    embedding's and head's pieces meet over mp for them, so each piece
    takes the update that one device computes from the whole parameter
    and the step's reduced gradient (``full_grads``)."""
    _, tm = _tp_ends_pair(2)
    kw = dict(learning_rate=0.1, lars_coeff=0.1, device="cpu")
    tst = TrainStep(
        tm, topt.LarsMomentum(parameters=tm.parameters(), **kw),
        loss_fn=GPTPretrainingCriterion(),
        mesh=build_mesh(dp=2, mp=2, pp=2, devices=["cpu"] * 8),
        strategy=_pipe_strategy(DistributedStrategy, "F-then-B"))
    names = ["pre.word_embeddings.weight", "post.lm_head.weight"]
    assert all("mp" in tst.param_specs[k] for k in names)
    before = {k: tst.engine.full_param(k).clone() for k in names}
    tst.keep_grads = True
    x, y = _batch()
    tst.step([torch.as_tensor(x)], [torch.as_tensor(y)])
    grads = tst.full_grads()
    for k in names:
        p = torch.nn.Parameter(before[k].clone())
        p.grad = grads[k]
        topt.LarsMomentum(parameters=[p], **kw).step()
        torch.testing.assert_close(tst.engine.full_param(k), p.detach(),
                                   rtol=1e-6, atol=1e-7, msg=k)


def test_indivisible_micro_batches_run_on_one_pipeline():
    """One row a micro-batch over dp=2 does not split: pipeline 0 runs
    the whole micro-batches and the other takes its update, which still
    equals JAX's."""
    jm, tm, jst, tst = _pipe_pair(dict(dp=2, pp=2), "F-then-B", M=8)
    x, y = _batch()
    run_both(jst, tst, [x], [y])
    jst.sync_to_layer()
    tst.sync_to_layer()
    assert_params_close(jm, tm)
    a, b = (tst.engine.leaves[tst.engine.rank(d, 0)]["blocks.0.ln1.weight"]
            for d in range(2))
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()

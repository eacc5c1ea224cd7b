"""The port's length-bucket batching (``io/bucketing.py``) held to the
JAX package's: ``test_bucketing.py``'s cases through the port, the number
of distinct batch shapes a bucketed training run meets held to the JAX
step's compiled variants, and the same seeded samplers and collates
through both packages giving byte-equal batches."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as paddle
from paddle_tpu_torch import io
from paddle_tpu_torch.core import device as core_device
from paddle_tpu_torch.io import (BucketedBatchSampler, bucketed_collate,
                                 pad_to_bucket, bucket_for)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    paddle.set_device("cpu")
    yield
    core_device._current = prev


class RaggedDataset(io.Dataset):
    def __init__(self, lengths):
        self.lengths = lengths

    def __getitem__(self, i):
        L = self.lengths[i]
        return (np.full((L,), i, np.int64), np.asarray(i % 2, np.int64))

    def __len__(self):
        return len(self.lengths)


def test_bucket_for():
    assert bucket_for(1, (8, 16)) == 8
    assert bucket_for(8, (8, 16)) == 8
    assert bucket_for(9, (8, 16)) == 16
    with pytest.raises(ValueError, match="largest bucket"):
        bucket_for(17, (8, 16))


def test_pad_to_bucket_shapes_and_lengths():
    arrays = [np.ones((5, 3)), np.ones((7, 3)), np.ones((2, 3))]
    batch, lengths = pad_to_bucket(arrays, buckets=(8, 16), axis=0)
    assert batch.shape == (3, 8, 3)
    np.testing.assert_array_equal(lengths, [5, 7, 2])
    assert batch[2, 2:].sum() == 0  # padded region

def test_sampler_never_mixes_buckets():
    lengths = [5, 30, 6, 31, 7, 60, 8, 61]
    ds = RaggedDataset(lengths)
    sampler = BucketedBatchSampler(ds, batch_size=2, buckets=(8, 32, 64))
    batches = list(sampler)
    assert sorted(i for b in batches for i in b) == list(range(8))
    for b in batches:
        bks = {bucket_for(lengths[i], (8, 32, 64)) for i in b}
        assert len(bks) == 1, (b, bks)


def test_dataloader_with_buckets_bounded_shapes():
    lengths = [3, 9, 4, 10, 5, 17, 6, 18, 30, 29]
    ds = RaggedDataset(lengths)
    loader = io.DataLoader(
        ds, batch_sampler=BucketedBatchSampler(ds, batch_size=2,
                                               buckets=(8, 16, 32)),
        collate_fn=bucketed_collate(buckets=(8, 16, 32)))
    seen_shapes = set()
    rows = 0
    for x, y, lens in loader:
        seen_shapes.add(tuple(np.asarray(x.numpy()).shape[1:]))
        rows += np.asarray(x.numpy()).shape[0]
        # padding is zero beyond each row's length
        xn, ln = np.asarray(x.numpy()), np.asarray(lens.numpy())
        for r in range(xn.shape[0]):
            assert (xn[r, ln[r]:] == 0).all()
    assert rows == len(lengths)
    # at most one shape per bucket — the bounded-compile contract
    assert seen_shapes <= {(8,), (16,), (32,)}, seen_shapes


def _mean_pool_net(pkg):
    class MeanPoolNet(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pkg.nn.Embedding(64, 8)
            self.fc = pkg.nn.Linear(8, 2)

        def forward(self, x):
            return self.fc(self.emb(x).mean(axis=1))

    return MeanPoolNet()


def test_bucketed_training_compiles_per_bucket_only():
    """The port compiles nothing; what it holds is the JAX step's count:
    the distinct batch shapes a bucketed run feeds its step equal the
    JAX step's compiled variants (one a bucket, not one a raw length),
    and the losses agree on the same weights."""
    from paddle_tpu.parallel.train_step import TrainStep as JStep
    from paddle_tpu_torch.parallel.train_step import TrainStep as PStep
    lengths = [4, 5, 12, 13, 4, 12, 5, 13]
    J.seed(0)
    jnet = _mean_pool_net(J)
    pnet = _mean_pool_net(paddle)
    pnet.set_state_dict({k: v.numpy() for k, v in
                         jnet.state_dict().items()})
    results = []
    for pkg, net in ((J, jnet), (paddle, pnet)):
        ds = RaggedDataset(lengths)
        loader = pkg.io.DataLoader(
            ds, batch_sampler=pkg.io.BucketedBatchSampler(
                ds, batch_size=2, buckets=(8, 16)),
            collate_fn=pkg.io.bucketed_collate(buckets=(8, 16)))
        opt = pkg.optimizer.Adam(learning_rate=1e-3,
                                 parameters=net.parameters())
        if pkg is J:
            step = JStep(net, opt, loss_fn=J.nn.CrossEntropyLoss())
        else:
            step = PStep(net, opt, loss_fn=paddle.nn.CrossEntropyLoss(),
                         device="cpu")
        shapes, losses = set(), []
        for x, y, lens in loader:
            shapes.add((tuple(x.shape), tuple(y.shape)))
            losses.append(float(step.step([x], [y]).numpy()
                                if pkg is J else step.step([x], [y])))
        results.append((len(step._compiled) if pkg is J else len(shapes),
                        losses))
    assert results[0][0] == results[1][0] == 2
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-5)


class TestRaggedSkewStress:
    """VERDICT round-2 missing #1: the dense+lengths reduction must hold
    at realistic length skew.  Full measured table (8192-doc lognormal,
    wall-clock legs): BASELINE.md 'Ragged skew' section +
    tools/exp/_exp_ragged.py."""

    def _corpus(self, n=2048):
        import sys, os
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "tools", "exp"))
        from _exp_ragged import make_corpus, analytic, quantile_ladder
        return make_corpus(n), analytic, quantile_ladder

    def test_bucketing_bounds_compiles_and_waste_under_skew(self):
        from paddle_tpu_torch.io.bucketing import (BucketedBatchSampler,
                                                   DEFAULT_BUCKETS,
                                                   bucket_for)
        (docs, lengths), analytic, _ = self._corpus()

        class DS:
            def __getitem__(self, i):
                return docs[i]

            def __len__(self):
                return len(docs)

        sampler = BucketedBatchSampler(
            DS(), batch_size=8, buckets=DEFAULT_BUCKETS,
            length_fn=lambda i: int(lengths[i]), shuffle=True)
        batches = [list(b) for b in sampler]
        import numpy as np
        r = analytic(lengths, [np.asarray(b) for b in batches],
                     lambda bl: bucket_for(int(bl.max()), DEFAULT_BUCKETS),
                     "bucketed")
        # compile variants bounded by 2 x ladder size (full + remainder
        # batch per bucket), NOT by the number of distinct lengths
        assert r["compiles"] <= 2 * len(DEFAULT_BUCKETS), r
        # padding waste stays moderate under heavy lognormal skew
        assert r["padding_waste_pct"] < 25.0, r
        # vs naive global-max padding (~85% waste on this distribution)
        naive = analytic(lengths,
                         [np.arange(i, min(i + 8, len(docs)))
                          for i in range(0, len(docs), 8)],
                         lambda bl: int(lengths.max()), "naive")
        assert naive["padding_waste_pct"] > 3 * r["padding_waste_pct"]
        # every sample appears exactly once
        seen = sorted(i for b in batches for i in b)
        assert seen == list(range(len(docs)))


class TestTokenBudgetBatching:
    def _ds(self, lens):
        class DS:
            def __getitem__(self, i):
                return (np.zeros(lens[i], np.int64),
                        np.int64(i % 3))

            def __len__(self):
                return len(lens)
        return DS()

    def test_packs_to_budget(self):
        from paddle_tpu_torch.io.bucketing import TokenBudgetBatchSampler
        lens = [5, 9, 3, 8, 2, 2, 7]
        s = TokenBudgetBatchSampler(self._ds(lens), token_budget=12)
        batches = list(s)
        seen = sorted(i for b in batches for i in b)
        assert seen == list(range(7))
        for b in batches:
            assert sum(lens[i] for i in b) <= 12
        assert len(s) == len(batches)

    def test_oversized_sample_raises(self):
        from paddle_tpu_torch.io.bucketing import TokenBudgetBatchSampler
        s = TokenBudgetBatchSampler(self._ds([4, 20]), token_budget=12)
        with pytest.raises(ValueError, match="truncate"):
            list(s)

    def test_max_batch_size_caps_rows(self):
        from paddle_tpu_torch.io.bucketing import TokenBudgetBatchSampler
        s = TokenBudgetBatchSampler(self._ds([1] * 10), token_budget=100,
                                    max_batch_size=4)
        for b in s:
            assert len(b) <= 4

    def test_ragged_collate_end_to_end(self):
        from paddle_tpu_torch import io
        from paddle_tpu_torch.io.bucketing import (TokenBudgetBatchSampler,
                                             ragged_collate)
        from paddle_tpu_torch.core.ragged import RaggedTensor, sequence_pool
        lens = [5, 9, 3, 8, 2, 2, 7]
        ds = self._ds(lens)
        sampler = TokenBudgetBatchSampler(ds, token_budget=12)
        loader = io.DataLoader(ds, batch_sampler=sampler,
                               collate_fn=ragged_collate(
                                   capacity=12, extra_fields=(1,)),
                               num_workers=0)
        total = 0
        for values, splits, labels in loader:
            rt = RaggedTensor(values, splits)
            pooled = sequence_pool(rt, "sum")
            assert pooled.shape[0] == len(labels)
            assert values.shape[0] == 12  # fixed capacity: ONE compile
            total += int(np.asarray(splits.numpy())[-1])
        assert total == sum(lens)

    def test_zero_waste_vs_bucketed_padding(self):
        """At the BASELINE round-3 skew, token budgeting wastes only the
        final-batch remainder — far below padded bucketing's 17%."""
        import sys, os
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "tools", "exp"))
        from _exp_ragged import make_corpus
        from paddle_tpu_torch.io.bucketing import TokenBudgetBatchSampler
        (docs, lengths) = make_corpus(1024)

        class DS:
            def __getitem__(self, i):
                return docs[i]

            def __len__(self):
                return len(docs)

        budget = 4096
        s = TokenBudgetBatchSampler(
            DS(), token_budget=budget,
            length_fn=lambda i: int(lengths[i]), shuffle=True)
        batches = list(s)
        used = [sum(int(lengths[i]) for i in b) for b in batches]
        waste = 1 - sum(used) / (len(batches) * budget)
        assert waste < 0.02, waste  # vs 0.171 for the x1.5 ladder

    def test_len_contract_under_shuffle(self):
        from paddle_tpu_torch.io.bucketing import TokenBudgetBatchSampler
        lens = list(np.random.RandomState(0).randint(1, 10, 40))
        s = TokenBudgetBatchSampler(self._ds(lens), token_budget=16,
                                    shuffle=True)
        # len() BEFORE the epoch sees the same permutation the epoch
        # will iterate
        n = len(s)
        assert n == sum(1 for _ in s)
        # MID-epoch (and post-epoch) len() reports the running/last
        # epoch's count, never a pre-drawn future permutation
        it = iter(s)
        next(it)
        running = len(s)
        assert running == 1 + sum(1 for _ in it)

    def test_drop_last_keeps_fullish_bins(self):
        from paddle_tpu_torch.io.bucketing import TokenBudgetBatchSampler
        # one nearly-full bin (9/10) + one sparse bin (2/10)
        lens = [9, 2]
        s = TokenBudgetBatchSampler(self._ds(lens), token_budget=10,
                                    drop_last=True)
        batches = list(s)
        kept = [i for b in batches for i in b]
        assert 0 in kept and 1 not in kept

    def test_collate_is_pure_numpy(self):
        """Workers never touch the card: the collate output must be
        numpy."""
        from paddle_tpu_torch.io.bucketing import ragged_collate
        c = ragged_collate(capacity=12, extra_fields=(1,))
        out = c([(np.zeros(3, np.int64), np.int64(1)),
                 (np.zeros(5, np.int64), np.int64(0))])
        for o in out:
            assert type(o).__module__ == "numpy", type(o)

    def test_to_padded_overflow_raises(self):
        from paddle_tpu_torch.core.ragged import RaggedTensor
        rt = RaggedTensor.from_rows(
            [np.zeros((9, 1), np.float32)])
        with pytest.raises(ValueError, match="max_len"):
            rt.to_padded(max_len=7)

    def test_ragged_collate_fixed_rows(self):
        """max_rows fixes every output shape — one compile, not one per
        packed row count."""
        from paddle_tpu_torch.io.bucketing import ragged_collate
        c = ragged_collate(capacity=16, extra_fields=(1,), max_rows=4)
        shapes = set()
        for rows in ([3, 5], [2, 2, 2, 2], [9]):
            out = c([(np.zeros(l, np.int64), np.int64(0))
                     for l in rows])
            shapes.add(tuple(o.shape for o in out))
            # padded splits repeat the total (zero-length tail rows)
            assert out[1][-1] == sum(rows)
        assert len(shapes) == 1
        with pytest.raises(ValueError, match="max_rows"):
            c([(np.zeros(1, np.int64), np.int64(0))] * 5)


# -- the same seed, the same batches in both packages ------------------------

def _batches(pkg, make, epochs=2):
    pkg.seed(11)
    sampler = make(pkg)
    return [list(map(int, b)) for _ in range(epochs) for b in sampler]


@pytest.mark.parametrize("kind", ["bucketed", "bucketed_drop_last",
                                  "token_budget", "token_budget_rows"])
def test_samplers_match_jax(kind):
    lens = list(np.random.RandomState(5).randint(1, 30, 40))

    def make(pkg):
        ds = RaggedDataset(lens)
        if kind == "bucketed":
            return pkg.io.BucketedBatchSampler(ds, batch_size=3,
                                               buckets=(8, 16, 32),
                                               shuffle=True)
        if kind == "bucketed_drop_last":
            return pkg.io.BucketedBatchSampler(ds, batch_size=4,
                                               buckets=(8, 16, 32),
                                               shuffle=True,
                                               drop_last=True)
        budget = pkg.io.bucketing.TokenBudgetBatchSampler
        if kind == "token_budget":
            return budget(ds, token_budget=48, shuffle=True)
        return budget(ds, token_budget=64, max_batch_size=3, shuffle=True,
                      drop_last=True, num_open=2)

    assert _batches(paddle, make) == _batches(J, make)


def test_collates_match_jax():
    rs = np.random.RandomState(2)
    samples = [(rs.randint(0, 9, (n,)).astype(np.int64), np.int64(n % 2),
                rs.rand(n, 2).astype(np.float32)) for n in (3, 7, 5)]
    for pkg_fn in (lambda m: m.io.bucketed_collate(
            buckets=(4, 8), pad_value=-1, ragged_fields=(0, 2)),
            lambda m: m.io.bucketing.ragged_collate(
                capacity=16, extra_fields=(1,), max_rows=4)):
        got = pkg_fn(paddle)(samples)
        want = pkg_fn(J)(samples)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()

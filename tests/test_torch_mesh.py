"""The port's ``(mp, dp)`` serving mesh held to the JAX package.

The JAX side runs on the 8 virtual CPU devices that tests/conftest.py
forces, its ragged kernel in interpret mode; the port's side maps every
rank onto the CPU (``ServingMesh(2, 2, devices=["cpu"] * 4)``) and runs
the plain kernels.

* Rank order, and ``shard`` against JAX's placement of every
  ``SERVING_SPECS`` kind: each rank holds the shard the JAX device of the
  same ``(m, d)`` holds, and ``unshard`` gives the tensor back.
* B4 (``sharded_ragged_paged_attention``) against the JAX ``shard_map``
  wrapper on the inputs of tests/test_sharded_serving.py (global block
  ids, each slot's blocks in its own dp shard's range): stream and
  gather bodies, fp32 and int8 pools, atol 1e-5 (summation order); the
  plain form of its one launch per card group
  (``ragged_group_attention_ref``) held the same way, and the grouping of
  a mesh's ranks by card (``card_groups``).
* ``to_tensor_parallel()``: the forward equals the dense one and JAX's
  tensor-parallel model's on bridged weights (atol 1e-5).
* The mesh engine's greedy streams token-identical to the JAX engine's
  at ``mesh=2``, ``(1, 2)`` and ``(2, 2)`` (ragged, fp32 and int8 KV);
  seeded mesh streams equal to the unsharded port engine's; the
  ``kv_budget_mb`` block counts equal the JAX engine's; each mesh
  validation error of the JAX engine.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch.convert import (export_paddle_tpu_state,
                                      load_paddle_tpu_state)
from paddle_tpu_torch.distributed import (SERVING_SPECS, ServingMesh,
                                          all_gather, all_reduce_sum,
                                          get_mesh, serving_mesh, set_mesh,
                                          shard, unshard)
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.ops import ragged_paged_attn as rpa_mod
from paddle_tpu_torch.ops.ragged_paged_attn import (
    sharded_ragged_paged_attention, sharded_ragged_paged_attention_ref)
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving import quant as tq

torch.set_num_threads(1)

MAX_NEW = 8
ENGINE_KW = dict(num_slots=4, max_seq_len=48, kv_block_size=8,
                 prefill_chunk=8)


def _cpu_mesh(mp, dp):
    return ServingMesh(mp, dp, devices=["cpu"] * (mp * dp))


@pytest.fixture(autouse=True)
def _mesh_guard():
    """The JAX engine claims its process-global mesh; restore it (and the
    port's) so no other test inherits one."""
    from paddle_tpu.distributed import mesh as jax_mesh
    prev = jax_mesh.get_mesh()
    prev_port = get_mesh()
    yield
    jax_mesh.set_mesh(prev)
    set_mesh(prev_port)


@pytest.fixture(scope="module")
def models():
    """(JAX dense, JAX tensor-parallel, port dense on the same weights)."""
    paddle.seed(0)
    jm = JaxGPT.from_config("tiny", dropout=0.0)
    jm.eval()
    tm = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    load_paddle_tpu_state(
        tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    tm.eval()
    return jm, jm.to_tensor_parallel(), tm


# -- the mesh and its layouts ------------------------------------------------
def test_rank_order_matches_jax_build_mesh():
    """Rank (m, d) of the port's mesh is device ``d * mp + m`` of its list,
    where the JAX ``serving_mesh(mp, dp)`` puts the same device."""
    import jax
    from paddle_tpu.distributed.mesh import serving_mesh as jax_serving_mesh
    devs = jax.devices()
    for mp, dp in ((2, 2), (2, 1), (1, 2), (4, 2)):
        jm = jax_serving_mesh(mp, dp)
        arr = np.asarray(jm.devices).reshape(dp, mp)
        tm = ServingMesh(mp, dp, devices=["cpu"] * (mp * dp))
        assert tm.ranks() == [(m, d) for d in range(dp) for m in range(mp)]
        for m, d in tm.ranks():
            assert devs.index(arr[d, m]) == tm.rank(m, d)
        assert tm.mp_group(0) == [torch.device("cpu")] * mp


def test_serving_mesh_needs_its_devices():
    """Without enough cards ``serving_mesh`` names ``devices=``, as the JAX
    one names XLA_FLAGS; a ServingMesh gets exactly mp * dp devices."""
    with pytest.raises(ValueError, match="devices="):
        serving_mesh(2, 2, devices=[])
    m = serving_mesh(2, 2, devices=["cpu"] * 6)
    assert (m.mp, m.dp, m.size) == (2, 2, 4)
    assert m.shape == {"mp": 2, "dp": 2}
    with pytest.raises(ValueError, match="needs 4 devices, got 3"):
        ServingMesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="needs devices="):
        ServingMesh(2, 2)
    with pytest.raises(ValueError, match=">= 1"):
        ServingMesh(0, 2, devices=[])
    assert set_mesh(m) is m and get_mesh() is m


@pytest.mark.parametrize("kind", sorted(SERVING_SPECS))
def test_shard_matches_jax_placement_and_round_trips(kind):
    """Every serving kind: the port's shard of rank (m, d) equals the
    shard JAX's ``serving_sharding`` places on the device of (m, d), and
    ``unshard`` restores the tensor exactly."""
    import jax
    from paddle_tpu.distributed.mesh import serving_mesh as jax_serving_mesh
    from paddle_tpu.distributed.sharding import serving_sharding
    shapes = {"kv": (6, 8, 4, 16), "kv_scale": (6, 4), "state": (4,),
              "table": (4, 6), "replicated": (3, 5)}
    x = np.random.RandomState(0).randn(*shapes[kind]).astype(np.float32)
    jm = jax_serving_mesh(2, 2)
    placed = jax.device_put(x, serving_sharding(jm, kind))
    by_dev = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    arr = np.asarray(jm.devices).reshape(2, 2)
    mesh = _cpu_mesh(2, 2)
    parts = shard(torch.tensor(x), kind, mesh)
    for m, d in mesh.ranks():
        np.testing.assert_array_equal(parts[mesh.rank(m, d)].numpy(),
                                      by_dev[arr[d, m]])
        assert parts[mesh.rank(m, d)].is_contiguous()
    assert torch.equal(unshard(parts, kind, mesh), torch.tensor(x))


def test_shard_places_replicas_once_per_device():
    """Ranks holding one slice on one device share the tensor; a slice
    that divides unevenly raises."""
    mesh = _cpu_mesh(2, 2)
    w = torch.randn(8, 6)
    rep = shard(w, "replicated", mesh)
    assert all(p is rep[0] for p in rep)
    cols = shard(w, (None, "mp"), mesh)
    assert cols[mesh.rank(0, 0)] is cols[mesh.rank(0, 1)]
    assert cols[mesh.rank(0, 0)] is not cols[mesh.rank(1, 0)]
    with pytest.raises(ValueError, match="divide"):
        shard(torch.randn(3, 5), ("dp", None), mesh)
    with pytest.raises(ValueError, match="unknown serving array kind"):
        shard(w, "heads", mesh)


def test_collectives_sum_and_gather_over_a_group():
    group = [torch.device("cpu")] * 2
    a, b = torch.randn(3, 4), torch.randn(3, 4)
    s = all_reduce_sum([a, b], group)
    assert len(s) == 2 and s[0] is s[1] and torch.equal(s[0], a + b)
    g = all_gather([a, b], -1, group)
    assert torch.equal(g[1], torch.cat([a, b], -1))
    with pytest.raises(ValueError, match="3 ranks"):
        all_reduce_sum([a, b], group + group[:1])


# -- B4 against the JAX shard_map wrapper -------------------------------------
def _b4_inputs():
    """tests/test_sharded_serving.py's case: B=4 slots, W=4, H=4, hd=8,
    bs=8, 4 table entries, 10 pool blocks (5 per dp shard); GLOBAL block
    ids, each slot drawing from its own shard's range."""
    B, W, H, hd, bs, bps = 4, 4, 4, 8, 8, 4
    NB = 10
    rng = np.random.RandomState(0)
    q = rng.randn(B, W, H, hd).astype(np.float32)
    k = rng.randn(NB * bs, H, hd).astype(np.float32)
    v = rng.randn(NB * bs, H, hd).astype(np.float32)
    nb_local = NB // 2
    tables = np.zeros((B, bps), np.int32)
    for b in range(B):
        base = (b // 2) * nb_local
        tables[b] = base + 1 + (np.arange(bps) % (nb_local - 1))
    pos = np.array([5, 9, 0, 13], np.int32)
    width = np.array([3, 4, 0, 2], np.int32)
    codes_k = rng.randint(-127, 128, (NB * bs, H, hd)).astype(np.int8)
    codes_v = rng.randint(-127, 128, (NB * bs, H, hd)).astype(np.int8)
    ks = (rng.rand(NB, H).astype(np.float32) + 0.5) / 127.0
    vs = (rng.rand(NB, H).astype(np.float32) + 0.5) / 127.0
    return dict(q=q, k=k, v=v, tables=tables, pos=pos, width=width, bs=bs,
                codes_k=codes_k, codes_v=codes_v, ks=ks, vs=vs)


def _b4_port(x, quant, variant, fn=sharded_ragged_paged_attention):
    mesh = _cpu_mesh(2, 2)
    kv = ("dp", "mp", None)
    k, v = (x["codes_k"], x["codes_v"]) if quant else (x["k"], x["v"])
    sc = {}
    if quant:
        sc = dict(k_scale_shards=shard(torch.tensor(x["ks"]), "kv_scale",
                                       mesh),
                  v_scale_shards=shard(torch.tensor(x["vs"]), "kv_scale",
                                       mesh))
    outs = fn(shard(torch.tensor(x["q"]), ("dp", None, "mp", None), mesh),
              shard(torch.tensor(k), kv, mesh),
              shard(torch.tensor(v), kv, mesh), torch.tensor(x["tables"]),
              torch.tensor(x["pos"]), torch.tensor(x["width"]),
              block_size=x["bs"], mesh=mesh, variant=variant, **sc)
    assert [tuple(o.shape) for o in outs] == [(2, 4, 2, 8)] * 4
    return unshard(outs, ("dp", None, "mp", None), mesh).numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("variant", ["stream", "gather"])
def test_b4_plain_form_matches_jax_sharded_wrapper(variant, quant):
    """B4's plain form on the port's shards against the JAX
    ``sharded_ragged_paged_attention`` over a (2, 2) mesh (interpret
    mode), and against the unsharded JAX kernel: atol 1e-5.  The wrapper
    on CPU shards runs exactly the plain form."""
    import jax.numpy as jnp
    from paddle_tpu.distributed.mesh import serving_mesh as jax_serving_mesh
    from paddle_tpu.ops.ragged_paged_attn import (
        ragged_paged_attention as jax_rpa,
        sharded_ragged_paged_attention as jax_sharded)
    x = _b4_inputs()
    k, v = (x["codes_k"], x["codes_v"]) if quant else (x["k"], x["v"])
    sc = (dict(k_scale=jnp.asarray(x["ks"]), v_scale=jnp.asarray(x["vs"]))
          if quant else {})
    args = [jnp.asarray(a) for a in (x["q"], k, v, x["tables"], x["pos"],
                                     x["width"])]
    want = np.asarray(jax_sharded(*args, block_size=x["bs"],
                                  mesh=jax_serving_mesh(2, 2),
                                  interpret=True, variant=variant, **sc))
    unsharded = np.asarray(jax_rpa(*args, block_size=x["bs"],
                                   interpret=True, variant=variant, **sc))
    got = _b4_port(x, quant, variant, fn=sharded_ragged_paged_attention_ref)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, unsharded, atol=1e-5, rtol=1e-5)
    assert not got[2].any()                      # the parked slot
    before = sharded_ragged_paged_attention.launches
    np.testing.assert_array_equal(_b4_port(x, quant, variant), got)
    assert sharded_ragged_paged_attention.launches == before  # CPU: none


@pytest.mark.parametrize("case", ["one_card", "four_cards", "two_cards",
                                  "sixteen_on_one", "cpu_dp"])
def test_card_groups_take_the_ranks_of_a_card_in_rank_order(case):
    """B4's launches: the ranks grouped by device in rank order, at most
    ``MAX_GROUP_RANKS`` a group, with each rank's dp index from
    ``mesh.ranks()``."""
    mp, dp, devices, want = {
        "one_card": (2, 2, ["cuda:0"] * 4, [("cuda:0", [0, 1, 2, 3])]),
        "four_cards": (2, 2, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"],
                       [("cuda:0", [0]), ("cuda:1", [1]), ("cuda:2", [2]),
                        ("cuda:3", [3])]),
        "two_cards": (2, 2, ["cuda:0", "cuda:0", "cuda:1", "cuda:1"],
                      [("cuda:0", [0, 1]), ("cuda:1", [2, 3])]),
        "sixteen_on_one": (4, 4, ["cuda:0"] * 16,
                           [("cuda:0", list(range(8))),
                            ("cuda:0", list(range(8, 16)))]),
        "cpu_dp": (1, 2, ["cpu"] * 2, [("cpu", [0, 1])]),
    }[case]
    mesh = ServingMesh(mp, dp, devices=devices)
    groups = rpa_mod.card_groups(mesh)
    assert [(str(dev), ranks) for dev, ranks in groups] == want
    assert max(len(r) for _, r in groups) <= rpa_mod.MAX_GROUP_RANKS
    if case == "one_card":
        assert [mesh.ranks()[r][1] for r in groups[0][1]] == [0, 0, 1, 1]


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("variant", ["stream", "gather"])
def test_group_plain_form_matches_sharded_ref_and_jax(variant, quant):
    """The plain form of one launch over the (2, 2) mesh's four ranks on
    one device (``ragged_group_attention_ref``): each rank's slots read
    from the whole batch's tables of GLOBAL ids and localized as the
    kernel reads them.  Equal to B4's per-rank plain form and to the JAX
    ``sharded_ragged_paged_attention`` (interpret mode) at atol 1e-5."""
    import jax.numpy as jnp
    from paddle_tpu.distributed.mesh import serving_mesh as jax_serving_mesh
    from paddle_tpu.ops.ragged_paged_attn import (
        sharded_ragged_paged_attention as jax_sharded)
    x = _b4_inputs()
    mesh = _cpu_mesh(2, 2)
    k, v = (x["codes_k"], x["codes_v"]) if quant else (x["k"], x["v"])
    kv, qspec = ("dp", "mp", None), ("dp", None, "mp", None)
    qs = shard(torch.tensor(x["q"]), qspec, mesh)
    kss, vss = (shard(torch.tensor(p), kv, mesh) for p in (k, v))
    scs = [[None] * 4, [None] * 4]
    if quant:
        scs = [shard(torch.tensor(x[n]), "kv_scale", mesh)
               for n in ("ks", "vs")]
    members = [(qs[r], kss[r], vss[r], scs[0][r], scs[1][r], d)
               for r, (_, d) in enumerate(mesh.ranks())]
    t, p, w = (torch.tensor(x[n]) for n in ("tables", "pos", "width"))
    nb_local = kss[0].shape[0] // x["bs"]
    out = rpa_mod.ragged_group_attention_ref(
        members, t, p, w, block_size=x["bs"], nb_local=nb_local,
        variant=variant)
    got = unshard(list(out.split(qs[0].shape[0])), qspec, mesh).numpy()
    ssc = (dict(k_scale_shards=scs[0], v_scale_shards=scs[1]) if quant
           else {})
    ref = unshard(sharded_ragged_paged_attention_ref(
        qs, kss, vss, t, p, w, block_size=x["bs"], mesh=mesh,
        variant=variant, **ssc), qspec, mesh).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    sc = (dict(k_scale=jnp.asarray(x["ks"]), v_scale=jnp.asarray(x["vs"]))
          if quant else {})
    want = np.asarray(jax_sharded(
        *[jnp.asarray(a) for a in (x["q"], k, v, x["tables"], x["pos"],
                                   x["width"])],
        block_size=x["bs"], mesh=jax_serving_mesh(2, 2), interpret=True,
        variant=variant, **sc))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_b4_validation():
    """B4 refuses what the JAX wrapper refuses, and mismatched shards."""
    x = _b4_inputs()
    mesh = _cpu_mesh(2, 2)
    qs = shard(torch.tensor(x["q"]), ("dp", None, "mp", None), mesh)
    ks = shard(torch.tensor(x["k"]), ("dp", "mp", None), mesh)
    t, p, w = (torch.tensor(x[n]) for n in ("tables", "pos", "width"))
    kw = dict(block_size=8, mesh=mesh)
    with pytest.raises(ValueError, match="divide by the mesh's dp"):
        sharded_ragged_paged_attention(qs, ks, ks, t[:3], p[:3], w[:3],
                                       **kw)
    with pytest.raises(ValueError, match="3 shards"):
        sharded_ragged_paged_attention(qs[:3], ks, ks, t, p, w, **kw)
    with pytest.raises(ValueError, match="k_scale_shards and"):
        sharded_ragged_paged_attention(qs, ks, ks, t, p, w,
                                       k_scale_shards=ks, **kw)
    with pytest.raises(ValueError, match="whole heads"):
        sharded_ragged_paged_attention(qs[:3] + [qs[3][:, :, :1]], ks, ks,
                                       t, p, w, **kw)
    with pytest.raises(ValueError, match="variant"):
        sharded_ragged_paged_attention(qs, ks, ks, t, p, w, variant="x",
                                       **kw)
    with pytest.raises(ValueError, match="needs a mesh"):
        sharded_ragged_paged_attention(qs, ks, ks, t, p, w, block_size=8)
    set_mesh(mesh)
    out = sharded_ragged_paged_attention(qs, ks, ks, t, p, w, block_size=8)
    assert len(out) == 4
    assert "sharded_ragged_paged_attention" in rpa_mod.KERNEL_OPS


# -- the tensor-parallel model -------------------------------------------------
def test_to_tensor_parallel_matches_dense_and_jax(models):
    """The relayout computes the dense forward (atol 1e-5) and the JAX
    tensor-parallel model's forward on the same weights; its state is the
    JAX TP state name for name (the bridge is a copy both ways)."""
    jm, jtp, tm = models
    tp = tm.to_tensor_parallel()
    assert tp.to_tensor_parallel() is tp and not tp.training
    ids = np.random.RandomState(3).randint(0, 128, (2, 12)).astype(np.int32)
    with torch.no_grad():
        dense = tm(torch.tensor(ids.astype(np.int64))).numpy()
        got = tp(torch.tensor(ids.astype(np.int64))).numpy()
    want = np.asarray(jtp(paddle.to_tensor(ids))._data)
    np.testing.assert_allclose(got, dense, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    jstate = {n: np.asarray(p._data) for n, p in jtp.named_parameters()}
    tstate = export_paddle_tpu_state(tp)
    assert sorted(tstate) == sorted(jstate)
    for name, arr in jstate.items():
        np.testing.assert_array_equal(tstate[name], arr, err_msg=name)
    fresh = GPTModel.from_config("tiny", device="cpu", dropout=0.0,
                                 use_mp=True, seed=5)
    load_paddle_tpu_state(fresh, jstate)
    with torch.no_grad():
        np.testing.assert_array_equal(
            fresh(torch.tensor(ids.astype(np.int64))).numpy(), got)


def test_to_tensor_parallel_refuses_other_variants(models):
    _, _, tm = models
    m = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    m.load_state_dict(tm.state_dict())
    tq.relayout_weights_int8(m)
    with pytest.raises(ValueError, match="dense Linear weights"):
        m.to_tensor_parallel()
    moe = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    moe.blocks[1].mlp = torch.nn.Identity()
    with pytest.raises(ValueError, match="MoE"):
        moe.to_tensor_parallel()
    sp = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    sp.blocks[0].attn.use_sp = True
    with pytest.raises(ValueError, match="sequence-parallel"):
        sp.to_tensor_parallel()


# -- the mesh engine against the JAX engine -----------------------------------
def _prompts():
    """Four prompts sharing a 17-token system prefix (two full blocks of
    8) and one without it."""
    rng = np.random.RandomState(7)
    system = rng.randint(0, 128, 17).astype(np.int32)
    tails = [rng.randint(0, 128, n).astype(np.int32) for n in (4, 9, 2, 6)]
    return ([np.concatenate([system, t]) for t in tails]
            + [rng.randint(0, 128, 11).astype(np.int32)])


def _serve(eng, prompts, seeded=False):
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW,
                       **(dict(temperature=0.8, top_k=20, seed=500 + i)
                          if seeded and i % 2 else {}))
            for i, p in enumerate(prompts)]
    eng.run_until_idle()
    return [r.result(timeout=5).tolist() for r in reqs]


MESH_CASES = {
    "mp2": ((2, 1), {}),
    "dp2_dense": ((1, 2), {}),
    "mp2dp2": ((2, 2), {}),
    "mp2dp2_int8kv": ((2, 2), dict(kv_dtype="int8")),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_engine_matches_jax_mesh_engine(models, case):
    """Greedy streams token-identical to the JAX engine's on the same mesh
    shape (ragged, chunked prefill), its prefix hits equal too; the
    engine's attributes, per-rank pools and per-shard block pool follow
    the mesh."""
    jm, jtp, tm = models
    (mp, dp), kw = MESH_CASES[case]
    prompts = _prompts()
    jeng = JaxEngine(jtp if mp > 1 else jm,
                     mesh=(mp, dp) if dp > 1 else mp, attn_impl="ragged",
                     registry=monitor.StatRegistry(), **ENGINE_KW, **kw)
    want = _serve(jeng, prompts)
    model = tm.to_tensor_parallel() if mp > 1 else tm
    eng = Engine(model, mesh=_cpu_mesh(mp, dp), **ENGINE_KW, **kw)
    assert _serve(eng, prompts) == want
    assert eng.prefix_hits == jeng.registry.get("serving.prefix_hits").value
    assert (eng.mp, eng.dp) == (mp, dp)
    assert eng.mesh_axes == {k: v for k, v in dict(mp=mp, dp=dp).items()
                             if v > 1}
    assert eng.block_pool.shards == dp
    pool = eng.k_pools[0]
    assert len(pool) == mp * dp
    quant = "kv_dtype" in kw
    rows = eng.block_pool.rows_per_shard
    for p in pool:
        assert isinstance(p, tq.QuantKV) == quant
        assert tuple(p.shape) == (rows, 8, 4 // mp, 16)
        if quant:
            assert tuple(p.scale.shape) == (rows, 4 // mp)


def test_mesh_slots_draw_blocks_from_their_own_shard(models):
    """Mid-run, every table entry of a dp shard's slot lies in that shard's
    pool range (the rule B4's localization depends on), and parked slots
    point at their own shard's scratch block."""
    _, _, tm = models
    eng = Engine(tm.to_tensor_parallel(), mesh=_cpu_mesh(2, 2),
                 **ENGINE_KW)
    for p in _prompts():
        eng.submit(p, max_new_tokens=MAX_NEW)
    rows = eng.block_pool.rows_per_shard
    seen = 0
    while not eng.scheduler.idle():
        eng.step()
        for i in range(eng.num_slots):
            d = i // 2
            assert eng._slot_scratch[i] == d * rows
            table = eng._block_tables[i]
            assert ((table >= d * rows) & (table < (d + 1) * rows)).all()
            seen += int((table != d * rows).sum())
    assert seen > 0


@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8"),
                                dict(attn_impl="ragged_gather")],
                         ids=["fp32", "int8kv", "gather"])
def test_seeded_mesh_streams_equal_unsharded(models, kw):
    """Seeded lanes draw with per-lane keys on the full logits, so a
    (2, 2) mesh gives the unsharded port engine's streams, greedy and
    seeded, and repeats them."""
    _, _, tm = models
    prompts = _prompts()
    base = _serve(Engine(tm, device="cpu", **ENGINE_KW, **kw), prompts,
                  seeded=True)
    tp = tm.to_tensor_parallel()
    a = _serve(Engine(tp, mesh=_cpu_mesh(2, 2), **ENGINE_KW, **kw), prompts,
               seeded=True)
    b = _serve(Engine(tp, mesh=_cpu_mesh(2, 2), **ENGINE_KW, **kw), prompts,
               seeded=True)
    assert a == b == base


def test_kv_budget_blocks_equal_jax(models):
    """``kv_budget_mb`` is a per-rank budget: at (1, 2) and (2, 2) the
    block counts, the per-shard block bytes and the per-shard free lists
    equal the JAX engine's; (2, 2) holds 4x the unsharded blocks at
    ``tiny``."""
    jm, jtp, tm = models
    kw = dict(num_slots=4, max_seq_len=48, kv_block_size=8, kv_budget_mb=1)
    counts = {}
    for mesh in ((1, 2), (2, 2)):
        mp, dp = mesh
        jeng = JaxEngine(jtp if mp > 1 else jm, mesh=mesh,
                         registry=monitor.StatRegistry(), **kw)
        teng = Engine(tm.to_tensor_parallel() if mp > 1 else tm,
                      mesh=_cpu_mesh(mp, dp), prefill_chunk=8, **kw)
        assert teng._kv_managed == jeng._kv_managed
        assert teng.kv_block_bytes == jeng._kv_code_bytes_per_shard
        for d in range(dp):
            assert teng.block_pool.free_count(d) == \
                jeng.block_pool.free_count(d) == teng._kv_managed // dp
        counts[mesh] = teng._kv_managed
    one = Engine(tm, device="cpu", prefill_chunk=8, **kw)._kv_managed
    assert counts[1, 2] == 2 * one and counts[2, 2] == 4 * one
    # an explicit kv_blocks rounds up to whole dp shards
    eng = Engine(tm, mesh=_cpu_mesh(1, 2), kv_blocks=25, **ENGINE_KW)
    assert eng._kv_managed == 26


@pytest.mark.parametrize("mesh, kw, err, match", [
    ("dense_mp2", {}, ValueError, "tensor-parallel model form"),
    ((2, 2, 2), {}, ValueError, r"\(mp, dp\)"),
    ("two", {}, ValueError, "ServingMesh"),
    ((2, 2), {}, ValueError, "devices="),
    ("tp_mp3", {}, ValueError, "num_heads"),
    ("dp2", dict(num_slots=3), ValueError, "divide by the mesh's dp"),
    ("tp_dp2", dict(weight_dtype="int8"), ValueError,
     "tensor-parallel einsum form"),
    ("dense_mp2dp2", dict(weight_dtype="int8"), ValueError,
     "tensor-parallel model form"),
    ("tp_dp2", dict(device="cuda:1"), ValueError, "first rank's device"),
    ("dp2", dict(kv_blocks=10), ValueError, "per dp shard"),
], ids=["dense_mp", "three_axes", "not_a_mesh", "no_cards", "heads",
        "slots", "int8_weights_tp", "int8_weights_dp", "device",
        "too_few_blocks"])
def test_mesh_validation(models, mesh, kw, err, match):
    """Each mesh error the JAX engine raises (weight-only int8 beside mp >
    1 included: its dense model cannot shard heads); nothing is
    relayouted before the error."""
    _, _, tm = models
    tp = tm.to_tensor_parallel()
    model, mesh = {
        "dense_mp2": (tm, _cpu_mesh(2, 1)), "tp_mp3": (tp, _cpu_mesh(3, 1)),
        "dp2": (tm, _cpu_mesh(1, 2)), "tp_dp2": (tp, _cpu_mesh(1, 2)),
        "dense_mp2dp2": (tm, _cpu_mesh(2, 2)),
    }.get(mesh if isinstance(mesh, str) else "", (tp, mesh))
    cfg = dict(ENGINE_KW, **kw)
    with pytest.raises(err, match=match):
        Engine(model, mesh=mesh, **cfg)
    assert all(isinstance(m, torch.nn.Linear)
               for m in (tm.blocks[0].attn.qkv_proj, tm.blocks[0].mlp.fc1))


def test_mesh_step_failure_rebuilds_rank_pools(models, monkeypatch):
    """A tick that raises fails its requests and rebuilds every rank's
    pool shard; the engine then serves the same streams as a fresh one.
    Stale codes in recycled int8 blocks do not leak on any rank."""
    _, _, tm = models
    tp = tm.to_tensor_parallel()
    prompts = _prompts()[:3]
    kw = dict(ENGINE_KW, kv_dtype="int8")
    want = _serve(Engine(tp, mesh=_cpu_mesh(2, 2), **kw), prompts)
    eng = Engine(tp, mesh=_cpu_mesh(2, 2), **kw)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]

    def boom(*a, **k):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(eng._runner, "_fused_ragged_tick_slots", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    monkeypatch.undo()
    for r in reqs:
        with pytest.raises(RuntimeError, match="engine step failed"):
            r.result(timeout=1)
    assert all(int(p.codes.abs().sum()) == 0
               for layer in eng.k_pools + eng.v_pools for p in layer)
    for layer in eng.k_pools + eng.v_pools:
        for p in layer:
            p.codes.fill_(127)
            p.scale.fill_(3.0)
    assert _serve(eng, prompts) == want


def test_tensor_parallel_loss_equals_dense(models):
    """With labels the tensor-parallel form's loss (the fused head + CE,
    reading the column-parallel ``[E, V]`` head weight) equals the dense
    model's, and its gradients flow on one device."""
    _, _, tm = models
    tp = tm.to_tensor_parallel()
    for m in (tm, tp):
        m.fused_loss = True
    ids = torch.tensor(np.random.RandomState(4).randint(0, 128, (2, 17)))
    try:
        with torch.no_grad():
            want = float(tm(ids[:, :-1], labels=ids[:, 1:]))
        loss = tp(ids[:, :-1], labels=ids[:, 1:])
        loss.backward()
    finally:
        tm.fused_loss = False
    assert abs(float(loss) - want) < 1e-5
    assert tp.blocks[0].attn.qkv_weight.grad is not None

"""The port's mesh engine on every layout the JAX engine serves over a mesh,
held to the JAX package.

The cases are JAX's own (tests/test_sharded_serving.py): ``LAYOUTS`` at
``mesh=2`` (contiguous rows, paged, chunked, spec and ragged) and
``DP_LAYOUTS`` over ``(1, 2)``, ``(2, 1)`` and ``(2, 2)`` (paged, chunked,
spec, ragged and int8 KV), served the way JAX's tests serve them (six
prompts, two admitted mid-decode of the first wave).  JAX's default
``attn_impl`` is ``"xla"`` and the port's ``"ragged"``, so a non-ragged
case names ``attn_impl="xla"`` on the port's side.  The JAX side runs on
the 8 virtual CPU devices tests/conftest.py forces; the port maps every
rank onto the CPU.

* greedy streams token-identical to the JAX mesh engine's on the same
  mesh shape;
* seeded streams equal to the port's unsharded engine's (the RNG
  contract: per-lane keys on the full logits), and repeating;
* beside JAX's cases, host sampling (its seeded numpy streams) and
  bucketed whole-prompt prefill over ``(2, 2)``, and the contiguous rows'
  per-rank shards ``[B/dp, L, H/mp, hd]``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import ServingMesh, get_mesh, set_mesh
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.serving import Engine

torch.set_num_threads(1)

LAYOUTS = [
    pytest.param(dict(), id="contiguous"),
    pytest.param(dict(kv_block_size=8), id="paged"),
    pytest.param(dict(kv_block_size=8, prefill_chunk=8), id="chunked"),
    pytest.param(dict(kv_block_size=8, spec_k=3), id="spec"),
    pytest.param(dict(kv_block_size=8, prefill_chunk=8, spec_k=2,
                      attn_impl="ragged"), id="ragged"),
]
DP_MESHES = [(1, 2), (2, 1), (2, 2)]
DP_LAYOUTS = [
    pytest.param(dict(kv_block_size=8), id="paged"),
    pytest.param(dict(kv_block_size=8, prefill_chunk=8), id="chunked"),
    pytest.param(dict(kv_block_size=8, spec_k=3), id="spec"),
    pytest.param(dict(kv_block_size=8, prefill_chunk=8, spec_k=2,
                      attn_impl="ragged"), id="ragged"),
    pytest.param(dict(kv_block_size=8, kv_dtype="int8"), id="int8kv"),
]


@pytest.fixture(autouse=True)
def _mesh_guard():
    from paddle_tpu.distributed import mesh as jax_mesh
    prev, prev_port = jax_mesh.get_mesh(), get_mesh()
    yield
    jax_mesh.set_mesh(prev)
    set_mesh(prev_port)


@pytest.fixture(scope="module")
def models():
    """(JAX dense, JAX tensor-parallel, port dense, port tensor-parallel)
    on the same weights."""
    paddle.seed(0)
    jm = JaxGPT.from_config("tiny", dropout=0.0)
    jm.eval()
    tm = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    load_paddle_tpu_state(
        tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    tm.eval()
    return jm, jm.to_tensor_parallel(), tm, tm.to_tensor_parallel()


def _prompts(n=6, base=7):
    rng = np.random.RandomState(base)
    lens = (5, 7, 3, 9, 4, 6)
    return [rng.randint(0, 128, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _drive(eng, prompts, max_new=8, seeded=False):
    """JAX's serving-test shape: staggered submits (two steps after the
    middle one), then run to idle."""
    reqs = []
    for i, p in enumerate(prompts):
        kw = (dict(temperature=0.9, top_p=0.8, seed=1234 + i)
              if seeded else {})
        reqs.append(eng.submit(p, max_new_tokens=max_new, **kw))
        if i == len(prompts) // 2:
            for _ in range(2):
                eng.step()
    eng.run_until_idle()
    return [list(map(int, r.generated)) for r in reqs]


def _port_kw(kw):
    return {"attn_impl": "xla", **kw}


def _jax_mesh_engine(models, mesh, kw):
    jm, jtp, _, _ = models
    mp, dp = mesh
    return JaxEngine(jtp if mp > 1 else jm, mesh=mesh if dp > 1 else mp,
                     num_slots=4, max_seq_len=48,
                     registry=monitor.StatRegistry(), **kw)


def _port_engine(models, mesh, kw):
    _, _, tm, tp = models
    if mesh is None:
        return Engine(tm, device="cpu", num_slots=4, max_seq_len=48,
                      **_port_kw(kw))
    mp, dp = mesh
    return Engine(tp if mp > 1 else tm,
                  mesh=ServingMesh(mp, dp, devices=["cpu"] * (mp * dp)),
                  num_slots=4, max_seq_len=48, **_port_kw(kw))


def _check(models, mesh, kw):
    prompts = _prompts()
    want = _drive(_jax_mesh_engine(models, mesh, kw), prompts)
    eng = _port_engine(models, mesh, kw)
    assert _drive(eng, prompts) == want, f"greedy ({mesh}, {kw})"
    assert (eng.mp, eng.dp) == mesh
    assert eng.registry.get("serving.mesh_devices").value == mesh[0] * mesh[1]
    base = _drive(_port_engine(models, None, kw), prompts, seeded=True)
    got = _drive(_port_engine(models, mesh, kw), prompts, seeded=True)
    assert got == base, f"seeded ({mesh}, {kw})"
    return eng


@pytest.mark.parametrize("kw", LAYOUTS)
def test_mesh2_layouts_match_jax_mesh_engine(models, kw):
    """JAX's ``LAYOUTS`` at ``mesh=2``: greedy token-identical to the JAX
    engine's ``mesh=2``, seeded equal to the port's unsharded engine."""
    eng = _check(models, (2, 1), kw)
    if "kv_block_size" not in kw:
        # contiguous rows: each rank its heads of every slot's row
        for p in eng.k_pools[0]:
            assert tuple(p.shape) == (4, 48, 2, 16)


@pytest.mark.parametrize("mesh", DP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("kw", DP_LAYOUTS)
def test_dp_layouts_match_jax_mesh_engine(models, kw, mesh):
    """JAX's ``DP_LAYOUTS`` over ``(1, 2)``, ``(2, 1)`` and ``(2, 2)``:
    greedy token-identical to the JAX engine on the same mesh, seeded
    equal to the port's unsharded engine."""
    _check(models, mesh, kw)


@pytest.mark.parametrize("kw", [
    dict(sample_mode="host", async_depth=1),
    dict(kv_block_size=8, sample_mode="host", async_depth=1),
    dict(prefill_buckets="pow2"),
    dict(prefill_chunk=8),
], ids=["host_contiguous", "host_paged", "buckets", "contiguous_chunked"])
def test_more_xla_paths_over_2x2(models, kw):
    """Beyond JAX's lists, over ``(2, 2)``: host sampling (each dp
    group's logits meet in slot order before numpy draws, so a seeded
    host stream does not depend on the mesh), bucketed whole-prompt
    prefill and chunks into contiguous rows.  Greedy equal to the JAX
    engine on the same mesh, seeded equal to the port unsharded, and a
    second mesh engine repeats them."""
    _check(models, (2, 2), kw)
    prompts = _prompts()
    a = _drive(_port_engine(models, (2, 2), kw), prompts, seeded=True)
    b = _drive(_port_engine(models, (2, 2), kw), prompts, seeded=True)
    assert a == b

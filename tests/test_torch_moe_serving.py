"""An MoE GPT served by the port's engine, held to the JAX engine.

A tiny GPT with ``moe_experts=8, moe_every=1`` is bridged from a JAX
model made from a seed, and every MoE layer is set to capacity factor 0.5
in both packages, so that tokens are dropped (the test counts them).
Capacity makes the rows of a window interact (a padding or idle lane
can take a real token's expert slot), so equal greedy streams need every
MoE layer fed the same window rows as the JAX engine feeds it.  The
streams must equal the JAX engine's of the same configuration: the
ragged path, the XLA contiguous and paged paths, speculative decoding,
int8 weights (the router and expert stacks stay f32 in both packages),
LoRA adapter lanes, and the serving mesh, the dense form over dp and the
tensor-parallel form over mp (the MoE runs once over the whole batch, as
GSPMD runs it).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import ServingMesh, moe
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.serving import Engine

torch.set_num_threads(1)

CFG = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
           max_position=64, dropout=0.0, moe_experts=8, moe_every=1)


def _pair(**kw):
    paddle.seed(0)
    jm = JaxGPT(**dict(CFG, **kw))
    tm = GPTModel(**dict(CFG, **kw))
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    for m in (jm, tm):
        m.eval()
        for blk in m.blocks:
            blk.mlp.capacity_factor = 0.5
    return jm, tm


@pytest.fixture
def drops(monkeypatch):
    """Tokens the port's MoE layers dropped, counted per routing call."""
    counted = []
    real = moe.top_k_routing

    def routing(*a):
        out = real(*a)
        counted.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(moe, "top_k_routing", routing)
    return counted


def _prompts(n=6, lens=(5, 21, 3, 17, 7, 12)):
    rng = np.random.RandomState(7)
    return [rng.randint(0, 128, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _serve(eng, prompts):
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    return [r.result(timeout=1)[len(p):].tolist()
            for r, p in zip(reqs, prompts)]


RAGGED = dict(kv_block_size=8, prefill_chunk=8, attn_impl="ragged")


@pytest.mark.parametrize("cfg", [
    RAGGED,
    dict(attn_impl="xla", kv_block_size=None, prefill_chunk=None),
    dict(attn_impl="xla", kv_block_size=8, prefill_chunk=8),
    dict(RAGGED, spec_k=3),
    dict(RAGGED, weight_dtype="int8"),
], ids=["ragged", "xla_contiguous", "xla_paged", "ragged_spec3",
        "ragged_int8_weights"])
def test_engine_streams_equal_jax_with_drops(drops, cfg):
    """Capacity makes a window's rows interact (a padding lane can take a
    real token's slot), so equal streams need the same window rows fed to
    every MoE layer as the JAX engine feeds them."""
    from paddle_tpu import monitor
    from paddle_tpu.serving import Engine as JaxEngine
    jm, tm = _pair()
    jkw = {k: v for k, v in cfg.items() if v is not None}
    prompts = _prompts()
    want = _serve(JaxEngine(jm, registry=monitor.StatRegistry(),
                            num_slots=4, max_seq_len=48, **jkw), prompts)
    got = _serve(Engine(tm, device="cpu", num_slots=4, max_seq_len=48,
                        **cfg), prompts)
    assert got == want
    assert sum(drops) > 0
    if cfg.get("weight_dtype"):
        for m in (tm,):
            for blk in m.blocks:
                assert blk.mlp.gate.dtype == torch.float32
                assert blk.mlp.experts.w1.dtype == torch.float32
        for blk in jm.blocks:
            assert str(blk.mlp.experts.w1._data.dtype) == "float32"


@pytest.mark.parametrize("mesh,mp_form", [((1, 2), False), ((2, 1), True),
                                          ((2, 2), True)],
                         ids=["dp2_dense", "mp2_tensor_parallel", "mp2_dp2"])
def test_mesh_streams_equal_jax_with_drops(drops, mesh, mp_form):
    """``Engine(mesh=...)`` over the CPU: a dense-form MoE model on a dp
    mesh (the engine relayouts its attention and keeps the MoE blocks
    whole) and a ``use_mp=True`` MoE model on mp; the streams equal the
    JAX engine's on its forced-device mesh and the unsharded port
    engine's."""
    from paddle_tpu import monitor
    from paddle_tpu.serving import Engine as JaxEngine
    jm, tm = _pair(use_mp=mp_form)
    kw = dict(num_slots=4, max_seq_len=48, **RAGGED)
    prompts = _prompts()
    want = _serve(JaxEngine(jm, registry=monitor.StatRegistry(), mesh=mesh,
                            **kw), prompts)
    n = mesh[0] * mesh[1]
    got = _serve(Engine(tm, device="cpu", mesh=ServingMesh(
        *mesh, devices=["cpu"] * n), **kw), prompts)
    assert got == want
    assert _serve(Engine(tm, device="cpu", **kw), prompts) == want
    assert sum(drops) > 0


def test_adapter_streams_equal_jax_with_drops(drops):
    """LoRA lanes on an MoE model (every other request on adapter "a"):
    the adapter delta rides the attention's output projection, the MoE
    sees the same rows; streams equal the JAX engine's."""
    from paddle_tpu import monitor
    from paddle_tpu.serving import Engine as JaxEngine
    from paddle_tpu.serving.lora import LoRAAdapter as JaxLoRA
    from paddle_tpu_torch.serving import LoRAAdapter
    jm, tm = _pair()
    kw = dict(num_slots=4, max_seq_len=48, **RAGGED)
    prompts = _prompts()
    outs = []
    for eng in (JaxEngine(jm, registry=monitor.StatRegistry(), adapters={
            "a": JaxLoRA.random(4, 64, n_layers=2, seed=11, scale=0.5)},
            **kw),
            Engine(tm, device="cpu", adapters={
                "a": LoRAAdapter.random(4, 64, n_layers=2, seed=11,
                                        scale=0.5)}, **kw)):
        reqs = [eng.submit(p, max_new_tokens=6,
                           **({"adapter": "a"} if i % 2 else {}))
                for i, p in enumerate(prompts)]
        eng.run_until_idle()
        outs.append([r.result(timeout=1)[len(p):].tolist()
                     for r, p in zip(reqs, prompts)])
    assert outs[1] == outs[0]
    assert sum(drops) > 0

"""Run a JAX-package test module's tests against the port.

The port's ``serving/faults.py``, ``router.py``, ``routerd.py``,
``supervisor.py`` and ``httpd.py`` are copies of the JAX package's, so
the JAX package's own tests of them are the port's tests too:
``port_copy`` compiles a ``tests/test_*.py`` file with its imports of
the JAX package's serving, monitor and launcher modules pointed at the
port's, and its ``Engine`` replaced by ``port_engine`` — the port's
engine on the CPU over the same weights, bridged from the JAX model the
test builds (``convert.load_paddle_tpu_state``), and its
``LoRAAdapter`` by ``MirrorLoRA``.  The JAX model itself stays the
test's reference (its ``generate`` gives the greedy streams the port
must reproduce token for token).

``cases`` lists a module's tests as ``pytest.param``s carrying their
marks; ``run`` calls one, supplying the fixtures it names.
"""
import inspect
import os
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models import GPTModel
from paddle_tpu_torch.serving import Engine, LoRAAdapter

TESTS = os.path.dirname(os.path.abspath(__file__))

SWAPS = (
    ("from paddle_tpu import monitor", "from paddle_tpu_torch import monitor"),
    ("from paddle_tpu.serving", "from paddle_tpu_torch.serving"),
    ("from paddle_tpu.distributed.launch",
     "from paddle_tpu_torch.distributed.launch"),
)

_bridged = {}  # id(JAX model) -> (JAX model, port model)


def port_model(jm):
    """The port's twin of a JAX ``tiny`` ``GPTModel`` (the config every
    mirrored test builds), with its weights; built once per JAX
    model."""
    hit = _bridged.get(id(jm))
    if hit is not None and hit[0] is jm:
        return hit[1]
    tm = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    load_paddle_tpu_state(
        tm, {n: np.asarray(p._data) for n, p in jm.named_parameters()})
    tm.eval()
    _bridged[id(jm)] = (jm, tm)
    return tm


def port_engine(model, **kw):
    """``Engine`` as the JAX tests call it, built by the port: on the
    CPU, over the bridged weights, the ragged kernel path where the
    configuration allows it (paged layout, device sampling) and the XLA
    path (the JAX engine's default) elsewhere."""
    if not isinstance(model, torch.nn.Module):
        model = port_model(model)
    kw.setdefault("device", "cpu")
    if "attn_impl" not in kw or kw["attn_impl"] is None:
        kw["attn_impl"] = ("ragged" if kw.get("kv_block_size")
                           and kw.get("sample_mode", "device") == "device"
                           else "xla")
    return Engine(model, **kw)


class MirrorLoRA(LoRAAdapter):
    """The port's ``LoRAAdapter``, whose ``merge_into`` also folds into a
    JAX model (through the JAX package's adapter with the same factors):
    a mirrored test builds its merged-weights oracle from the JAX model
    and serves the adapter on the port."""

    def merge_into(self, model):
        if isinstance(model, torch.nn.Module):
            return super().merge_into(model)
        from paddle_tpu.serving import LoRAAdapter as JaxLoRA
        return JaxLoRA(self.rank, self.A, self.B,
                       alpha=self.alpha).merge_into(model)


def port_copy(filename):
    """``tests/<filename>`` compiled against the port (module doc)."""
    path = os.path.join(TESTS, filename)
    with open(path) as f:
        src = f.read()
    for a, b in SWAPS:
        src = src.replace(a, b)
    mod = types.ModuleType("port_" + filename[:-3])
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    mod.Engine = port_engine
    if "LoRAAdapter" in mod.__dict__:
        mod.LoRAAdapter = MirrorLoRA
    return mod


def cases(mod, names):
    """``pytest.param(name)`` for each named test of ``mod``, with the
    test's own marks (a ``slow`` test is refused: the mirror runs in
    tier-1)."""
    out = []
    for name in names:
        fn = getattr(mod, name)
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name != "parametrize"]
        assert not any(m.name == "slow" for m in marks), name
        out.append(pytest.param(name, marks=marks, id=name))
    return out


def run(mod, test, fixtures, **params):
    """Call ``mod.<test>`` with the fixtures its signature names (from
    ``fixtures``) and any parametrized arguments."""
    fn = getattr(mod, test)
    args = {}
    for p in inspect.signature(fn).parameters:
        args[p] = params[p] if p in params else fixtures[p]
    return fn(**args)

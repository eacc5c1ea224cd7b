"""The seeded chaos storms of tests/test_faults.py, run against the port
(``torch_port_mirror``; ``chaos``): the full-feature engine (paged,
chunked, speculative, depth 2, priorities and preemption under dispatch
raises, d2h hangs the watchdog converts, pool exhaustion, slow host
ticks and proposer failures), the adapter and streaming front end
(hot-swaps killed at the bank write, clients vanishing mid-stream) and
the host tier (demotes and promotes killed mid-traffic), over the port's
CPU engine on weights bridged from the JAX ``tiny`` model.  Greedy
survivors are token-identical to JAX ``generate`` (adapter lanes to the
JAX model with the adapter merged), every waiter unblocks, the pools
return to refcount zero, and the same seed replays the same fault log
while another seed diverges.  (A file of its own: the storms take about
a minute on one CPU worker.)
"""
import pytest
import torch

import paddle_tpu as paddle
import torch_port_mirror as mirror
from paddle_tpu.models import GPTModel as JaxGPT

torch.set_num_threads(1)

PORT = mirror.port_copy("test_faults.py")

STORMS = [
    "test_chaos_storm_short_deterministic",
    "test_frontend_chaos_storm_deterministic",
    "test_offload_chaos_storm_deterministic",
]


@pytest.fixture(scope="module")
def tiny_gpt():
    paddle.seed(0)
    m = JaxGPT.from_config("tiny", dropout=0.0)
    m.eval()
    return m


@pytest.mark.parametrize("name", mirror.cases(PORT, STORMS))
def test_storm_on_the_port(name, tiny_gpt):
    """One of tests/test_faults.py's seeded storms, over the port's
    engine."""
    mirror.run(PORT, name, {"tiny_gpt": tiny_gpt})

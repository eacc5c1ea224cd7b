"""The port's geo-async tables held to the JAX package's, case for case
of ``tests/test_ps_geo.py``: local replicas, the interval delta flush
merged by sum, the per-trainer refresh, and the hashed table's grow +
``shrink(ttl)`` churn under a shifting id window (at a tenth of the JAX
test's window, which that file marks slow)."""
import pytest
import torch

from paddle_tpu import distributed as jdist
from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch.distributed import build_mesh
from paddle_tpu_torch.distributed import ps as tps

import torch_ps_cases as cases

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    return (jdist.build_mesh(dp=4, sharding=2),
            build_mesh(dp=4, sharding=2, devices=["cpu"] * 8))


@pytest.mark.parametrize("case", cases.GEO_CASES, ids=lambda c: c.__name__)
def test_geo_case_matches_jax(case, meshes, tmp_path):
    ref = case(cases.namespace(jps, meshes[0], tmp_path / "jax"))
    got = case(cases.namespace(tps, meshes[1], tmp_path / "port"))
    cases.assert_same(got, ref)
    if case is cases.geo_matches_sync_convergence:
        assert got["sync"][-1] < 1e-3
        assert got["geo_final"] < got["geo"][0] * 0.05
    if case is cases.hashed_churn_under_shifting_ids:
        assert all(a and b for a, b in got["books"])
        assert all(n > 0 for n in got["evicted"][3:])
        assert got["rows"] == got["rows_before"]

"""Every analysis type over every fault mix, the port against the JAX
package's coordinator: the seven types (the comprehensive pipeline and the
six single-agent analyses) over 60-service synthetic worlds of each fault
mix (crash, oom, image, config, pending, mixed) at seeds 1 and 3.  Each
package analyzes its own generator's world of the same seed.  The
contract: each agent's findings JSON byte-identical; for the
comprehensive analysis also the correlated groups byte-identical and the
root causes in the same order with every field equal (floats within rel
1e-5 / abs 1e-6, ``score`` within 1e-4).
"""

import pytest

from rca_tpu.cluster.generator import synthetic_cascade_world as ref_world
from rca_tpu.cluster.mock_client import MockClusterClient as RefClient
from rca_tpu.coordinator import RCACoordinator as RefCoordinator
from rca_tpu_torch.agents import ALL_AGENT_TYPES
from rca_tpu_torch.cluster.generator import synthetic_cascade_world
from rca_tpu_torch.cluster.mock_client import MockClusterClient
from rca_tpu_torch.coordinator import RCACoordinator
from test_torch_coordinator import _assert_causes_match, _dumps

TYPES = ("comprehensive",) + tuple(ALL_AGENT_TYPES)
MIXES = ("crash", "oom", "image", "config", "pending", "mixed")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("RCA_BACKEND", "RCA_EXPLAIN", "RCA_COLUMNAR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RCA_KERNEL_CACHE", "off")


def test_the_grid_covers_seven_types():
    assert len(TYPES) == 7 and len(set(TYPES)) == 7


@pytest.mark.parametrize("analysis", TYPES)
@pytest.mark.parametrize("seed", [1, 3])
@pytest.mark.parametrize("mix", MIXES)
def test_analysis_type_matches_reference(mix, seed, analysis, clean_env):
    world = synthetic_cascade_world(60, n_roots=1, seed=seed, fault_mix=mix)
    rw = ref_world(60, n_roots=1, seed=seed, fault_mix=mix)
    port = RCACoordinator(MockClusterClient(world), backend="torch",
                          device="cpu").run_analysis(analysis, "synthetic")
    ref = RefCoordinator(RefClient(rw), backend="jax").run_analysis(
        analysis, "synthetic")
    assert port["status"] == ref["status"] == "completed", port.get("error")
    pr, rr = port["results"], ref["results"]
    agents = ALL_AGENT_TYPES if analysis == "comprehensive" else (analysis,)
    for agent in agents:
        assert _dumps(pr[agent]) == _dumps(rr[agent]), agent
    if analysis == "comprehensive":
        pc, rc = pr["correlated"], rr["correlated"]
        assert _dumps(pc["groups"]) == _dumps(rc["groups"])
        _assert_causes_match(pc["root_causes"], rc["root_causes"])
        assert pc["root_causes"][0]["component"] in \
            rw.ground_truth["fault_roots"]
    assert sorted(pr) == sorted(rr)

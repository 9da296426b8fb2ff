"""`run_federated` with the baselines against the JAX package's, on the
protocol of ``tests/test_torch_scenarios.py`` (K=8, hidden 32, C=3,
40 dB, 3 rounds of 3 local steps), every JAX draw replayed through the
port's seam: FedAvg, COTAF and decentralized consensus, static and under
one masked or fault scenario each (the prox variants' runs are in
``tests/test_torch_prox.py``)."""
import pytest

from test_torch_scenarios import (ROUNDS, _assert_trajectory, _run_both,
                                  workload)  # noqa: F401  (a fixture)

K = 8


def assert_strategy_run(workload, strategy, scenario):  # noqa: F811
    """The port's run of ``strategy`` under ``scenario`` against JAX's,
    within the slice's tolerances; a dynamic run's records hold the heads
    only for a strategy with a cluster plan."""
    got, ref = _run_both(workload, scenario, strategy=strategy)
    _assert_trajectory(got, ref)
    if scenario != "paper-static":
        rec = got["scenario"]
        assert ("heads" in rec) == strategy.startswith("cwfl")
        assert len(rec["mask_mass"]) == ROUNDS
    return got


# FedAvg's weights are the round's mask (straggler-heavy); COTAF's server
# fails over when it crashes (flaky-clients); the decentralized graph
# loses the crashed nodes (head-failure).
@pytest.mark.parametrize("strategy,scenario", [
    ("fedavg", "paper-static"), ("fedavg", "straggler-heavy"),
    ("cotaf", "paper-static"), ("cotaf", "flaky-clients"),
    ("decentralized", "paper-static"), ("decentralized", "head-failure")])
def test_baseline_run_matches_jax(workload, strategy, scenario):  # noqa: F811
    got = assert_strategy_run(workload, strategy, scenario)
    if scenario != "paper-static":
        rec = got["scenario"]
        assert min(rec["mask_mass"]) < K            # somebody was absent
        if scenario != "straggler-heavy":
            assert min(rec["alive"]) < K            # the faults did strike

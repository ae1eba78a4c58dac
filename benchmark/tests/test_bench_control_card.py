"""On the card, at each cell's own size: the program's readings within the
cell's limits, the control's not (``python -m pytest benchmark/tests -m
card`` on a machine with a card; ``benchmark/control.py`` reads a dozen
seeds)."""

import json
import os

import pytest

from benchmark.harness import cell as cells

BENCH_JSON = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "BENCHMARK.json")
with open(BENCH_JSON) as f:
    WORKLOADS = [w["name"] for w in json.load(f)["workloads"]]


def _correct(numbers, limits):
    return all(numbers[k] <= v for k, v in limits.items())


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes_and_control_fails(card, workload):
    from heltondetection_tpu_torch.kernels import KERNELS
    from heltondetection_tpu_torch.kernels.build import build_all
    build_all(KERNELS)
    c = cells.load(workload)
    seed = 2 ** 31 + 101
    assert _correct(c.driver.readings(c, seed, card), c.limits)
    assert not _correct(c.driver.readings(c, seed, card, control=True),
                        c.limits)

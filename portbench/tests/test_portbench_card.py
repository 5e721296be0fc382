"""At each cell's own size on the card (and at a tiny size on the CPU): the
control (the plain reference with fp8 operands in the program's place) and
the planted faults fail the committed limits, on three seeds. Run there with

    python -m pytest --noconftest portbench/tests/test_portbench_card.py -q -s

(`-s` shows each seed's readings).
Skipped where there is no card (decided inside the test)."""

import json

import pytest

from portbench import control
from portbench.common import benchmark, cell_spec

pytestmark = pytest.mark.cuda
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the readings are at the cells' own sizes")
    return torch.device("cuda")


def fails(numbers: dict, limits: dict) -> list:
    return [k for k, limit in limits.items() if k in numbers and not numbers[k] <= limit]


@pytest.mark.parametrize("name", [w["name"] for w in benchmark()["workloads"]])
def test_control_and_faults_fail_the_limits(card, name):
    cell = cell_spec(name)
    limits = cell["mix"]["limits"]
    for seed in SEEDS:
        out = control.KINDS[cell["mix"]["kind"]](cell, seed, card)
        print(json.dumps({"workload": name, "seed": seed, **out}))
        for kind, numbers in out.items():
            assert fails(numbers, limits), (name, seed, kind, numbers, limits)


@pytest.mark.parametrize("name", [w["name"] for w in benchmark()["workloads"]])
def test_control_fails_the_limits_at_a_tiny_size(name):
    """The same control and faults on the CPU at the tests' tiny size
    (tests/tiny.py), against the committed limits, on one seed."""
    import torch

    from portbench.tests.tiny import tiny_cell

    cell = tiny_cell(name)
    out = control.KINDS[cell["mix"]["kind"]](cell, SEEDS[0], torch.device("cpu"))
    for kind, numbers in out.items():
        assert fails(numbers, cell["mix"]["limits"]), (name, kind, numbers)

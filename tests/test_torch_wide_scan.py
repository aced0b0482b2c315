"""The port's ``scan`` solver through the sidecar at 16,385 and 20,000
members against the JAX sidecar, on the CPU.

``tests/test_torch_wide_service.py``'s twin (the JAX ``AssignorService``
and the port's, ``device="cpu"``) gets the same ``assign`` line with
``solver="scan"`` for its whole topic: 40,000 uniform lags in [0, 10^6)
from seed 18, two full rounds of the greedy over every member (and at
16,385 part of a third; K7's cluster form on the card).  Both packages' CPU scans take a
step a row, so this file holds the scan apart from the other solvers.
The reply equals the JAX reply minus ids, times and ``stats.device``, and
the two registries move the same counter series.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_service import Twin  # noqa: E402
from test_torch_wide_groups import one_torch_thread  # noqa: E402
from test_torch_wide_service import (  # noqa: E402
    ABOVE,
    WIDE,
    assign_params,
    counts_balanced,
    group,
)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


@pytest.fixture()
def twin():
    pair = Twin()
    try:
        yield pair
    finally:
        pair.close()


@pytest.mark.parametrize("C", [ABOVE, WIDE])
def test_assign_scan_matches_jax(twin, C):
    lags, members = group(C)
    reply = twin.same("assign", assign_params(lags, members, "scan"))
    result = reply["result"]
    assert result["stats"]["device"] == "cpu"
    assert counts_balanced(result["assignments"], C)
    series = twin.series_moved_alike()
    assert series[("klba_requests_total", (("method", "assign"),))] == 1

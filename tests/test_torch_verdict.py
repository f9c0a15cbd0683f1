"""The ``dist.verdict`` fault site of the replicated deadline protocol.

The port's verdict barrier (``resilience/deadline._verdict_barrier``) marks
``dist.verdict`` before it joins the barrier, as the JAX package's does, and
``faults.KNOWN_SITES`` declares it as the JAX package's does.  Armed, the
site behaves the same in both packages: an unreachable barrier (``hang``,
a killed rank never answering) is an agreed breach, abandoned within the
watcher's bound; an error of the exchange (``raise``) propagates.
"""

import time

import pytest

from sboxgates_tpu.resilience import deadline as jdeadline
from sboxgates_tpu.resilience import faults as jfaults
from sboxgates_tpu_torch.resilience import deadline, faults


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


def test_site_is_declared_as_in_the_jax_package():
    assert "dist.verdict" in faults.KNOWN_SITES
    # The port has no ahead-of-time compile to warm, so no warmup.compile.
    assert set(faults.KNOWN_SITES) == set(jfaults.KNOWN_SITES) - {
        "warmup.compile"}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_hung_verdict_barrier_is_an_agreed_breach(pkg):
    dl, ft = (jdeadline, jfaults) if pkg == "jax" else (deadline, faults)
    ft.arm("dist.verdict", "hang")
    stats = {}
    t0 = time.monotonic()
    with pytest.raises(dl.DispatchTimeout):
        dl.replicated_dispatch_with_retry(
            lambda: "x",
            dl.DeadlineConfig(budget_s=0.2, retries=0),
            lambda breached: False,  # never reached: the watcher hangs
            stats=stats,
        )
    # Bounded by the watcher's abandon bound (two budgets plus one second,
    # plus its 5 s margin), not eternal.
    assert time.monotonic() - t0 < 12.0
    assert stats["replicated_aborts"] == 1
    assert stats.get("deadline_breaches", 0) == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_verdict_error_propagates(pkg):
    dl, ft = (jdeadline, jfaults) if pkg == "jax" else (deadline, faults)
    ft.arm("dist.verdict", "raise")
    with pytest.raises(ft.InjectedFault):
        dl.replicated_dispatch_with_retry(
            lambda: "x",
            dl.DeadlineConfig(budget_s=0.3, retries=2, backoff_s=0.01),
            lambda breached: False,
        )

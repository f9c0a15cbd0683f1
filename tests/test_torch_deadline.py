"""The port's hung-dispatch deadline against the JAX package's, on the CPU.

- ``run_with_deadline`` passes values and errors through and times out;
- ``dispatch_with_retry`` breaches, retries and gives up on the JAX
  package's schedule, with the same ``deadline_breaches`` and
  ``dispatch_retries`` counts; a disabled config calls inline and still
  fires the ``dispatch.sweep`` site;
- a 5-LUT sweep and a 7-LUT stage A hung at every attempt
  (``dispatch.sweep:hang@1+``) trip the circuit breaker and find, through
  the host chunk stream, the JAX package's first hit under the same spec,
  with the same counters; one hung attempt is retried to the unfaulted
  result;
- the host chunk stream's own device work under ``host_sync_deadline``
  raises when it hangs: the fallback fails loudly.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sboxgates_tpu.graph import xmlio as jxmlio
from sboxgates_tpu.resilience import deadline as jdeadline
from sboxgates_tpu.resilience import faults as jfaults
from sboxgates_tpu.search import context as jctx
from sboxgates_tpu.search import lut as jlut

from sboxgates_tpu_torch.core import ttable as tt
from sboxgates_tpu_torch.graph.xmlio import save_state
from sboxgates_tpu_torch.ops import sweeps
from sboxgates_tpu_torch.resilience import deadline
from sboxgates_tpu_torch.resilience import faults
from sboxgates_tpu_torch.search import context as tctx
from sboxgates_tpu_torch.search import lut as tlut

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_states import RIJNDAEL, planted_sbox, random_state  # noqa: E402

torch.set_num_threads(1)

COUNTERS = ("deadline_breaches", "dispatch_retries", "circuit_breaker_trips",
            "lut3_candidates", "lut5_candidates", "lut5_solved",
            "lut7_candidates", "lut7_solved")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


@pytest.fixture
def release():
    """An event the hung test attempts wait on; set at the end so their
    abandoned workers finish."""
    ev = threading.Event()
    yield ev
    ev.set()


def test_run_with_deadline_passes_values_and_errors():
    assert deadline.run_with_deadline(lambda: 5, 1.0) == 5
    with pytest.raises(KeyError, match="x"):
        deadline.run_with_deadline(lambda: {}["x"], 1.0)
    caller = threading.get_ident()
    assert deadline.run_with_deadline(threading.get_ident, 0) == caller
    assert deadline.run_with_deadline(threading.get_ident, 1.0) != caller


def test_run_with_deadline_times_out(release):
    t0 = time.monotonic()
    with pytest.raises(deadline.DispatchTimeout) as got:
        deadline.run_with_deadline(release.wait, 0.2, "lut5.pivot")
    assert time.monotonic() - t0 < 5
    with pytest.raises(jdeadline.DispatchTimeout) as want:
        jdeadline.run_with_deadline(release.wait, 0.2, "lut5.pivot")
    assert str(got.value).split("(")[0] == str(want.value).split("(")[0]
    assert isinstance(got.value, RuntimeError)


@pytest.mark.parametrize("hung,retries", [(0, 2), (1, 2), (2, 2), (3, 2),
                                          (1, 0), (2, 3)])
def test_retry_schedule_matches_the_jax_package(hung, retries, release):
    def run(mod):
        calls, reissued = [], []

        def fn():
            calls.append(1)
            if len(calls) <= hung:
                release.wait()
            return "done"

        cfg = mod.DeadlineConfig(budget_s=0.1, retries=retries, backoff_s=0.01)
        stats = {}
        try:
            out = mod.dispatch_with_retry(
                fn, cfg, stats=stats, label="t",
                on_retry=lambda: reissued.append(1),
            )
        except mod.DispatchTimeout:
            out = "timeout"
        return out, stats, len(calls), len(reissued)

    got, want = run(deadline), run(jdeadline)
    assert got == want
    assert got[0] == ("timeout" if hung > retries else "done")
    assert got[1].get("deadline_breaches", 0) == min(hung, retries + 1)


@pytest.mark.parametrize("cfg", [None, deadline.DeadlineConfig(budget_s=0)])
def test_disabled_deadline_calls_inline_and_fires_the_site(cfg):
    caller = threading.get_ident()
    assert deadline.dispatch_with_retry(threading.get_ident, cfg) == caller
    faults.arm("dispatch.sweep", "raise", "2")
    deadline.dispatch_with_retry(lambda: None, cfg)
    with pytest.raises(faults.InjectedFault):
        deadline.dispatch_with_retry(lambda: None, cfg)
    assert faults.hit_count("dispatch.sweep") == 2


def test_config_from_env_matches_the_jax_package(monkeypatch):
    for var, v in (("SBG_DISPATCH_TIMEOUT_S", "1.5"),
                   ("SBG_DISPATCH_RETRIES", "-3"),
                   ("SBG_DISPATCH_BACKOFF_S", "0.125")):
        monkeypatch.setenv(var, v)
    got, want = deadline.config_from_env(), jdeadline.config_from_env()
    assert (got.budget_s, got.retries, got.backoff_s, got.enabled) == (
        want.budget_s, want.retries, want.backoff_s, want.enabled)
    ctx = tctx.SearchContext(tctx.Options(device="cpu", dispatch_timeout_s=0))
    assert not ctx.deadline_cfg.enabled and ctx.deadline_cfg.retries == 0


# -- the drivers under a hung device -----------------------------------------


def _both(st, sbox, tmp_path, budget, seed=3):
    """The port's and the JAX package's (context, state, target, mask) of
    one node: the same state (through its XML file), target bit 0 of
    ``sbox``, a deadline of ``budget`` seconds."""
    path = save_state(st, str(tmp_path))
    target = tt.target_table(np.asarray(sbox, dtype=np.uint8), 0)
    mask = tt.mask_table(8)
    t = tctx.SearchContext(tctx.Options(seed=seed, lut_graph=True, device="cpu",
                                        dispatch_timeout_s=budget))
    j = jctx.SearchContext(jctx.Options(seed=seed, lut_graph=True,
                                        dispatch_timeout_s=budget))
    return (t, st, target, mask), (j, jxmlio.load_state(path), target, mask)


def _planted7_sbox(st, gates):
    """sboxes/rijndael.txt with output bit 0 replaced by the 7-LUT
    0xCA(0x96(a, b, c), 0xE8(d, e, f), g) over ``gates`` of ``st``."""
    from sboxgates_tpu_torch.utils.sbox import load_sbox

    a, b, c, d, e, f, g = (st.table(x) for x in gates)
    target = tt.eval_lut(0xCA, tt.eval_lut(0x96, a, b, c),
                         tt.eval_lut(0xE8, d, e, f), g)
    sbox, _ = load_sbox(RIJNDAEL)
    return (sbox & 0xFE) | tt.to_bits(target).astype(np.uint8)


def _counters(ctx):
    return {k: int(ctx.stats.get(k, 0)) for k in COUNTERS}


def _arm(spec):
    site, action, when = spec
    faults.arm(site, action, when)
    jfaults.arm(site, action, when)


@pytest.fixture
def fast_backoff(monkeypatch):
    monkeypatch.setenv("SBG_DISPATCH_BACKOFF_S", "0.01")


@pytest.mark.parametrize("kind", ["lut5", "lut7"])
def test_hung_sweep_degrades_to_the_jax_packages_first_hit(
        kind, tmp_path, fast_backoff):
    """The 5-LUT search, and the 7-LUT stage A (its stage B on the CPU
    takes tens of seconds and is not behind the breaker), each against a
    planted hit.  The host stream's own syncs get the whole retry
    schedule's budget (3 x ``budget``); each budget leaves that window
    several times the JAX package's slowest honest sync on a loaded CPU
    (about 0.4 s for the 5-LUT stream's first chunk, including its
    compile; a few ms for the 7-LUT stage A over C(12, 7) tuples)."""
    if kind == "lut5":
        st = random_state(30, 4)
        sbox = planted_sbox(st, gates=(25, 26, 27, 28, 29))
        search, budget = "lut5_search", 0.6
    else:
        st = random_state(12, 6)
        sbox = _planted7_sbox(st, (5, 6, 7, 8, 9, 10, 11))
        search, budget = "_lut7_collect_hits", 0.3
    (t, *targs), (j, *jargs) = _both(st, sbox, tmp_path, budget=budget)

    def same(got, want):
        if kind == "lut5":
            assert got is not None and got == want
        else:
            assert len(got[0]) > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)

    _arm(("dispatch.sweep", "hang", "1+"))
    same(getattr(tlut, search)(t, *targs, []), getattr(jlut, search)(j, *jargs, []))
    assert t.device_degraded and j.device_degraded
    assert _counters(t) == _counters(j)
    assert _counters(t)["deadline_breaches"] == 3
    assert _counters(t)["circuit_breaker_trips"] == 1
    # The breaker stays tripped: the next search goes straight to the host
    # stream, with no new hit of the site (its draws go on, as the JAX
    # package's do).
    if kind == "lut5":
        hits = faults.hit_count("dispatch.sweep")
        same(getattr(tlut, search)(t, *targs, []),
             getattr(jlut, search)(j, *jargs, []))
        assert faults.hit_count("dispatch.sweep") == hits
        assert _counters(t) == _counters(j)


def test_one_hung_attempt_is_retried_to_the_unfaulted_result(tmp_path,
                                                            fast_backoff):
    st = random_state(9, 2)
    (t, *targs), (j, *jargs) = _both(st, planted_sbox(st, gates=(4, 6, 8, 1, 2)),
                                     tmp_path, budget=1.5)
    # Compile the JAX package's sweep first, on a context of its own: its
    # cold compile (most of a second) would otherwise run inside the
    # retried attempt's 1.5 s window.
    jlut.lut3_search(jctx.SearchContext(jctx.Options(seed=3, lut_graph=True)),
                     jargs[0].copy(), *jargs[1:], [])
    _arm(("dispatch.sweep", "hang", "1"))
    got = tlut.lut3_search(t, st.copy(), *targs[1:], [])
    want = jlut.lut3_search(j, jargs[0].copy(), *jargs[1:], [])
    assert got == want
    assert _counters(t) == _counters(j)
    assert _counters(t)["deadline_breaches"] == 1
    assert _counters(t)["dispatch_retries"] == 1
    assert not t.device_degraded


class _Hangs:
    """A device verdict whose read never returns."""

    def any(self):
        return self

    def __bool__(self):
        time.sleep(3600)
        return False  # pragma: no cover


def test_host_stream_fails_loudly_when_its_sync_hangs(tmp_path, monkeypatch):
    st = random_state(30, 4)
    t = tctx.SearchContext(tctx.Options(seed=3, lut_graph=True, device="cpu",
                                        dispatch_timeout_s=0.1))
    t.trip_device_breaker()
    monkeypatch.setattr(
        sweeps, "lut_filter",
        lambda *a: (_Hangs(), torch.zeros(1), torch.zeros(1)),
    )
    target = tt.target_table(planted_sbox(st, gates=(25, 26, 27, 28, 29)), 0)
    with pytest.raises(deadline.DispatchTimeout, match="lut5.host_stream"):
        tlut.lut5_search(t, st, target, tt.mask_table(8), [])
    assert t.stats["deadline_breaches"] == 0  # no retry ladder on the host

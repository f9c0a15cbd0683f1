"""One rank of the port's multi-process tests (the counterpart of the JAX
package's ``tests/distributed_worker.py`` and
``tests/distributed_degrade_worker.py``), printing the same result lines.

Usage: ``torch_mesh_worker.py pod|degrade <rank> <port> <local shards>
<processes> [transient|exhaust] [cpu|cuda]`` (the device defaults to the
CPU)

Joins a group of ``processes`` ranks at ``127.0.0.1:<port>`` (gloo: CPU
ranks, or ranks sharing one card), with ``<local shards>`` shards per rank
(``SBG_LOCAL_SHARDS``), and runs on the process-spanning mesh:

- ``pod``: the planted G = 50 5-LUT search through the sharded pivot
  stream (RESULT), the planted G = 24 search through the sharded
  feasibility stream and its compact gather (RESULT2, whose dense
  reconstruction is held against the full gather: STREAMCHECK), the engine
  on crypto1 with the native-route agreement (ENGINE), the 7-LUT shape of
  the compact gather (STREAMCHECK7) and this rank's slice of a job-sharded
  permutation sweep on its local shards (SWEEP);
- ``degrade``: the planted G = 24 search unfaulted (REF), then with
  ``dispatch.sweep@rank:1`` hanging once (``transient``: one agreed abort,
  then the device path) or every window (``exhaust``: every rank degrades
  to the host chunk stream in the same window) (DEGRADE).

The states are the JAX package's ``tests/planted.py`` constructions, built
with the port's ``State``.  Exits with ``os._exit`` after a store barrier:
an abandoned attempt may still sit in a wedged collective, by design.
"""

import os
import sys

worker, rank, port, local, nproc = (
    sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5])
)
mode = sys.argv[6] if len(sys.argv) > 6 else None
DEVICE = sys.argv[7] if len(sys.argv) > 7 else "cpu"
os.environ["SBG_LOCAL_SHARDS"] = local
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from sboxgates_tpu_torch.core import boolfunc as bf  # noqa: E402
from sboxgates_tpu_torch.core import ttable as tt  # noqa: E402
from sboxgates_tpu_torch.graph.state import GATES, State  # noqa: E402
from sboxgates_tpu_torch.parallel import MeshPlan, make_mesh  # noqa: E402
from sboxgates_tpu_torch.parallel import distributed as dist  # noqa: E402
from sboxgates_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from sboxgates_tpu_torch.search import Options, SearchContext  # noqa: E402
from sboxgates_tpu_torch.search.lut import lut5_search  # noqa: E402

dist.initialize(f"127.0.0.1:{port}", nproc, rank, device=DEVICE)
NATIVE = not os.environ.get("SBG_DISABLE_NATIVE")


def planted_lut5(g=50, outer=(12, 26, 41), inner=(19, 33)):
    rng = np.random.default_rng(5)
    st = State.init_inputs(8)
    while st.num_gates < g:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(bf.XOR, int(a), int(b), GATES)
    o = tt.eval_lut(0x2D, *(st.table(x) for x in outer))
    target = tt.eval_lut(0xB4, o, st.table(inner[0]), st.table(inner[1]))
    return st, target, tt.mask_table(8)


def planted_lut7(gates=24):
    rng = np.random.default_rng(3)
    st = State.init_inputs(8)
    funs = [bf.AND, bf.OR, bf.XOR, bf.A_AND_NOT_B]
    while st.num_gates < gates:
        a, b = rng.choice(st.num_gates, size=2, replace=False)
        st.add_gate(funs[rng.integers(len(funs))], int(a), int(b), GATES)
    outer = tt.eval_lut(0x96, st.table(9), st.table(12), st.table(17))
    middle = tt.eval_lut(0xE8, st.table(10), st.table(15), st.table(21))
    return st, tt.eval_lut(0xCA, outer, middle, st.table(19)), tt.mask_table(8)


def ctx_for(plan=None, **kw):
    kw.setdefault("lut_graph", True)
    kw.setdefault("randomize", False)
    return SearchContext(Options(device=DEVICE, native=NATIVE, **kw),
                         mesh_plan=plan or MeshPlan(make_mesh(device=DEVICE)))


def encode(res):
    return "%d %d %s" % (res["func_outer"], res["func_inner"],
                         " ".join(str(g) for g in res["gates"]))


def streamcheck(ctx, st, target, mask, k, tag):
    """The compact gather's dense chunk against the full gather's."""
    prebuilt = ctx.stream_args(st, target, mask, [], k)
    base, total, chunk0 = prebuilt
    n = ctx.mesh_plan.n_candidate_shards
    chunk = -(-chunk0 // n) * n
    found, cstart, feas, r1, r0, _, _ = ctx.feasible_stream_driver(
        st, target, mask, [], k=k, prebuilt=prebuilt)
    assert found, "planted chunk must contain feasible rows"
    _, ff, r1f, r0f = pmesh.sharded_feasible_stream(
        ctx.mesh_plan, *base, cstart, total, k=k, chunk=chunk, compact=False)
    ff, r1f, r0f = (x.cpu().numpy() for x in (ff, r1f, r0f))
    feas, r1, r0 = (x.cpu().numpy() for x in (feas, r1, r0))
    assert (feas == ff).all(), "compacted feasibility diverges"
    assert (r1[ff] == r1f[ff]).all() and (r0[ff] == r0f[ff]).all()
    print("%s %d ok rows=%d" % (tag, rank, int(ff.sum())), flush=True)


def pod():
    st, target, mask = planted_lut5()
    res = lut5_search(ctx_for(), st, target, mask, [])
    assert res is not None, "distributed pivot search found nothing"
    print("RESULT %d %s" % (rank, encode(res)), flush=True)

    st2, t2, m2 = planted_lut5(24, (9, 12, 17), (10, 20))
    ctx2 = ctx_for()
    res2 = lut5_search(ctx2, st2, t2, m2, [])
    assert res2 is not None, "distributed chunked search found nothing"
    print("RESULT2 %d %s" % (rank, encode(res2)), flush=True)
    streamcheck(ctx2, st2, t2, m2, 5, "STREAMCHECK")

    from sboxgates_tpu_torch.search import make_targets
    from sboxgates_tpu_torch.search.kwan import create_circuit
    from sboxgates_tpu_torch.utils.sbox import load_sbox

    sbox, n_in = load_sbox(os.path.join(HERE, "..", "sboxes",
                                        "crypto1_fa.txt"))
    ctx3 = ctx_for(seed=3)
    st3 = State.init_inputs(n_in)
    out = create_circuit(ctx3, st3, make_targets(sbox)[0],
                         tt.mask_table(n_in), [])
    assert out != 0xFFFF, "mesh engine search found nothing"
    print("ENGINE %d out=%d gates=%d native=%s"
          % (rank, out, st3.num_gates, ctx3.uses_native_step(st3)),
          flush=True)

    st7, t7, m7 = planted_lut7()
    streamcheck(ctx_for(), st7, t7, m7, 7, "STREAMCHECK7")

    from sboxgates_tpu_torch.search.multibox import (
        permute_sweep_jobs,
        process_slice,
        search_boxes_one_output,
    )

    mine = process_slice(permute_sweep_jobs(sbox, n_in))
    ctx4 = ctx_for(plan=MeshPlan(make_mesh(pmesh.local_devices(DEVICE))),
                   seed=9)
    assert not ctx4.mesh_plan.spans_processes
    res4 = search_boxes_one_output(ctx4, mine, 0, save_dir=None,
                                   log=lambda s: None, batched=False)
    solved = sorted(name for name, sts in res4.items() if sts)
    assert len(solved) == len(mine), (solved, [b.name for b in mine])
    print("SWEEP %d %s" % (rank, ",".join(solved)), flush=True)


def degrade():
    from sboxgates_tpu_torch.resilience import faults

    st, target, mask = planted_lut5(24, (9, 12, 17), (10, 20))
    ref = lut5_search(ctx_for(), st, target, mask, [])
    assert ref is not None, "unfaulted reference search found nothing"
    print("REF %d %s" % (rank, encode(ref)), flush=True)
    # Only rank 1's guarded resolve blocks; rank 0 learns of the breach at
    # the verdict barrier.  A healthy resolve takes well under a second.
    faults.arm("dispatch.sweep@rank:1", "hang",
               "1" if mode == "transient" else "1+")
    ctx = ctx_for(dispatch_timeout_s=3.0)
    ctx.deadline_cfg.retries = 2
    ctx.deadline_cfg.backoff_s = 0.1
    res = lut5_search(ctx, st, target, mask, [])
    faults.disarm()
    assert res == ref, (res, ref)
    s = ctx.stats
    assert s["breach_barriers"] >= 1 and s["replicated_aborts"] >= 1, s
    if mode == "exhaust":
        assert s["degraded_ranks"] == 1 and ctx.device_degraded, s
        assert ctx.mesh_plan is None
    else:
        assert s["degraded_ranks"] == 0 and not ctx.device_degraded, s
        assert s["dispatch_retries"] >= 1, s
    print("DEGRADE %d mode=%s res=%s aborts>=1=%s degraded=%d"
          % (rank, mode, encode(res), s["replicated_aborts"] >= 1,
             s["degraded_ranks"]), flush=True)


{"pod": pod, "degrade": degrade}[worker]()
sys.stdout.flush()
dist.barrier("worker-done", timeout_s=120.0)
os._exit(0)

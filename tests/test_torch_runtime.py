"""The port's ``runtime`` (``repro_torch.runtime``: the straggler watchdog,
the work-stealing box scheduler, ``fail_worker`` and the simulated elastic
control plane) against the reference's ``repro.runtime``, on the CPU.

Both are pure Python; each case feeds the reference and the port the same
call sequence and compares every return value and the state after it:
mesh plans, generations and accumulation steps; watchdog flags; the
scheduler's assignments, steals, completions, requeues and results.
``tests/test_runtime.py``'s cases run on the port too. Tolerance: none.
"""

import threading

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.runtime import elastic as ref_elastic
from repro.runtime import straggler as ref_straggler
from repro_torch import runtime
from repro_torch.runtime import elastic, straggler
from repro_torch.runtime.elastic import (DevicePool, ElasticState, MeshPlan,
                                         accum_steps_for, plan_mesh)
from repro_torch.runtime.straggler import (BoxScheduler, StepTimeWatchdog,
                                           fail_worker)


def _plan(p):
    return None if p is None else (p.data, p.model, p.pod, p.n_devices,
                                   p.axes(), p.shape())


# ---------------------------------------------------------------------------
# elastic: plans, recovery cycles, accumulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_parallel", [1, 2, 4, 16])
@pytest.mark.parametrize("prefer_pods", [1, 2, 4])
def test_plan_mesh_equals_reference(model_parallel, prefer_pods):
    for n_alive in range(0, 300):
        assert _plan(plan_mesh(n_alive, model_parallel, prefer_pods)) == \
            _plan(ref_elastic.plan_mesh(n_alive, model_parallel,
                                        prefer_pods)), n_alive


@pytest.mark.parametrize("per_device", [1, 2, 3])
def test_accum_steps_equal_reference(per_device):
    for data in (1, 2, 4, 8, 16):
        for pod in (1, 2):
            for gb in (1, 7, 256, 1000):
                assert accum_steps_for(gb, MeshPlan(data, 16, pod),
                                       per_device) == \
                    ref_elastic.accum_steps_for(
                        gb, ref_elastic.MeshPlan(data, 16, pod), per_device)


@settings(max_examples=25, deadline=None)
@given(n_hosts=st.integers(4, 64),
       dph=st.sampled_from([1, 2, 4, 8]),
       mp=st.sampled_from([1, 2, 4, 8]),
       events=st.lists(st.tuples(st.booleans(), st.integers(0, 63)),
                       max_size=12))
def test_elastic_state_sequences_equal_reference(n_hosts, dph, mp, events):
    """The same failures and recoveries on both control planes: equal
    plans, generations, alive sets and grad-accumulation steps, and the
    same error when too few devices survive."""
    port = ElasticState(DevicePool(n_hosts, dph), model_parallel=mp,
                        global_batch=256)
    ref = ref_elastic.ElasticState(ref_elastic.DevicePool(n_hosts, dph),
                                   model_parallel=mp, global_batch=256)
    assert _plan(port.plan) == _plan(ref.plan)
    for fail, host in events:
        host %= n_hosts
        outs = []
        for st_ in (port, ref):
            try:
                outs.append(_plan(st_.on_failure(host) if fail
                                  else st_.on_recovery(host)))
            except RuntimeError as e:
                outs.append(("error", str(e)))
        assert outs[0] == outs[1]
        assert port.generation == ref.generation
        assert port.pool.alive_devices() == ref.pool.alive_devices()
        if port.plan is not None:
            assert port.grad_accum_steps(2) == ref.grad_accum_steps(2)


def test_elastic_cases_of_the_reference_suite():
    plan = plan_mesh(256, model_parallel=16)
    assert plan.model == 16 and plan.data == 16
    plan = plan_mesh(255, model_parallel=16)
    assert plan.model == 16 and plan.data == 8
    assert plan_mesh(8, model_parallel=16) is None
    st_ = ElasticState(DevicePool(n_hosts=64, devices_per_host=4),
                       model_parallel=16, global_batch=256)
    assert st_.plan.data == 16
    st_.on_failure(3)
    assert st_.plan.data == 8 and st_.generation == 1
    st_.on_recovery(3)
    assert st_.plan.data == 16
    for n_data in (16, 8, 4):
        plan = MeshPlan(data=n_data, model=16)
        acc = accum_steps_for(256, plan, per_device_batch=2)
        assert acc * plan.data * 2 >= 256
        assert (acc - 1) * plan.data * 2 < 256


# ---------------------------------------------------------------------------
# the straggler watchdog
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(times=st.lists(st.floats(0.01, 20.0, allow_nan=False), max_size=60),
       window=st.integers(1, 16), threshold=st.floats(1.1, 4.0),
       min_samples=st.integers(1, 10))
def test_watchdog_flags_equal_reference(times, window, threshold,
                                        min_samples):
    port = StepTimeWatchdog(window, threshold, min_samples)
    ref = ref_straggler.StepTimeWatchdog(window, threshold, min_samples)
    for t in times:
        assert port.record(t) == ref.record(t)
    assert port.flagged == ref.flagged
    assert list(port.times) == list(ref.times)


def test_watchdog_cases_of_the_reference_suite():
    wd = StepTimeWatchdog(min_samples=4, threshold=2.0)
    assert not any(wd.record(1.0) for _ in range(8))
    assert wd.record(5.0) is True
    assert wd.record(1.0) is False
    wd = StepTimeWatchdog(window=8, min_samples=4, threshold=2.5)
    for t in np.linspace(1.0, 2.0, 16):
        wd.record(float(t))
    assert wd.flagged == []


# ---------------------------------------------------------------------------
# the box scheduler and fail_worker
# ---------------------------------------------------------------------------

def _task(t):
    return None if t is None else (t.box_id, t.payload, t.assigned_to,
                                   t.t_assigned, t.done, t.result)


def _state(s):
    return (list(s.queue), {w: sorted(v) for w, v in s.inflight.items()},
            s.duplicates, s.requeues, s.pending(), s.all_done(),
            s.results(), [_task(s.tasks[i]) for i in sorted(s.tasks)])


OPS = st.lists(st.tuples(st.sampled_from(["next", "complete", "requeue",
                                          "fail"]),
                         st.integers(0, 3), st.integers(0, 11),
                         st.floats(0.0, 100.0, allow_nan=False)),
               max_size=40)


@settings(max_examples=40, deadline=None)
@given(n_boxes=st.integers(0, 12), n_workers=st.integers(1, 4),
       steal_after=st.sampled_from([0.0, 10.0, 60.0]), ops=OPS)
def test_scheduler_sequences_equal_reference(n_boxes, n_workers,
                                             steal_after, ops):
    """Random next_for / complete / requeue / fail_worker sequences: the
    same assignments (including steals of overdue boxes), the same
    effective completions, requeue and failure counts, and the same
    state after every call."""
    port = BoxScheduler(range(n_boxes), n_workers, steal_after)
    ref = ref_straggler.BoxScheduler(range(n_boxes), n_workers, steal_after)
    assert _state(port) == _state(ref)
    for op, w, box, now in ops:
        w %= n_workers
        if op == "next":
            out = [_task(s.next_for(w, now=now)) for s in (port, ref)]
        elif op == "complete":
            if not n_boxes:
                continue
            out = [s.complete(w, box % n_boxes, ("r", box))
                   for s in (port, ref)]
        elif op == "requeue":
            ids = [i for i in range(n_boxes) if (i + box) % 3 == 0]
            out = [port.requeue(ids), ref.requeue(ids)]
        else:
            out = [fail_worker(port, w), ref_straggler.fail_worker(ref, w)]
        assert out[0] == out[1], op
        assert _state(port) == _state(ref), op


def test_scheduler_cases_of_the_reference_suite():
    sched = BoxScheduler(range(20), n_workers=4)
    while not sched.all_done():
        for w in range(4):
            t = sched.next_for(w, now=0.0)
            if t:
                sched.complete(w, t.box_id, t.payload * 2)
    assert sched.results() == [i * 2 for i in range(20)]

    sched = BoxScheduler(range(6), n_workers=2)
    sched.next_for(0, now=0.0)
    sched.next_for(0, now=0.0)
    assert fail_worker(sched, 0) == 2
    while not sched.all_done():
        t = sched.next_for(1, now=0.0)
        assert t is not None
        sched.complete(1, t.box_id, 0)

    sched = BoxScheduler(range(2), n_workers=2, steal_after_s=10.0)
    t0 = sched.next_for(0, now=0.0)
    t1 = sched.next_for(1, now=0.0)
    sched.complete(1, t1.box_id, "r1")
    assert sched.next_for(1, now=5.0) is None
    stolen = sched.next_for(1, now=20.0)
    assert stolen is not None and stolen.box_id == t0.box_id
    assert sched.duplicates == 1
    assert sched.complete(1, stolen.box_id, "r-stolen") is True
    assert sched.complete(0, t0.box_id, "r-late") is False
    assert sched.tasks[t0.box_id].result == "r-stolen"


def test_concurrent_completion_counts_each_box_once(thread_guard):
    """Several threads complete every box (the serving layer's retry and
    straggler duplicates): exactly one completion per box is effective,
    the first result is kept, and the port agrees with the reference on
    the final results."""
    n_boxes, n_threads = 200, 6
    port = BoxScheduler(range(n_boxes), n_threads)
    ref = ref_straggler.BoxScheduler(range(n_boxes), n_threads)
    effective = {id(port): [], id(ref): []}
    lock = threading.Lock()
    start = threading.Barrier(2 * n_threads)

    def worker(sched, w):
        start.wait(30)
        won = [b for b in range(n_boxes) if sched.complete(w, b, b * 3)]
        with lock:
            effective[id(sched)].extend(won)

    threads = [threading.Thread(target=worker, args=(s, w))
               for s in (port, ref) for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    for s in (port, ref):
        assert sorted(effective[id(s)]) == list(range(n_boxes))
        assert s.all_done() and s.pending() == []
    assert port.results() == ref.results() == [b * 3
                                               for b in range(n_boxes)]
    assert port.requeue(range(n_boxes)) == ref.requeue(range(n_boxes)) == 0


def test_runtime_exports():
    assert runtime.BoxScheduler is straggler.BoxScheduler
    assert runtime.ElasticState is elastic.ElasticState
    for name in ("BoxScheduler", "BoxTask", "StepTimeWatchdog",
                 "fail_worker", "DevicePool", "ElasticState", "MeshPlan",
                 "plan_mesh", "accum_steps_for"):
        assert name in runtime.__all__

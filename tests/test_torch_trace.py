"""The port's tracer (utils/timers.py): spans, counters and host reads, and
the spans the trainer and the serving path record.

With tracing off a span is one shared null context and records nothing;
with it on, nested spans record their parents and the counters credited to
the innermost one. A traced run computes exactly what an untraced one does:
the same parameters bit for bit, the same epoch records, the same replies.
"""

from __future__ import annotations

import collections

import pytest
import torch

from gppvae_tpu_torch.data import build_rotated_digits
from gppvae_tpu_torch.eval.serving import build_server_state, predict_images
from gppvae_tpu_torch.train import train_gppvae as tg
from gppvae_tpu_torch.utils import NullLogger, timers
from gppvae_tpu_torch.utils.timers import PhaseTimer, Tracer, self_ns
from _one_thread import one_thread  # noqa: F401

BASE = dict(mode="joint", zdim=6, epochs=1, batch_size=16, lr_gp=5e-3, seed=3,
            obj_feature_dim=4, view_num_freqs=2, enc_features=(8, 16), dec_features=(16, 8))
PHASES = ("A_encode", "B_solve", "C_minibatch", "eval_oos")


@pytest.fixture(scope="module")
def ds():
    return build_rotated_digits("synthetic", num_objects=10, num_views=8, seed=0)


@pytest.fixture
def tracing():
    """The process's tracer on for the test, and emptied before and after."""
    timers.take()
    timers.set_tracing(True)
    try:
        yield timers.TRACER
    finally:
        timers.set_tracing(False)
        timers.take()


def _train(ds, **kw):
    return tg.train_gppvae(ds, tg.GPPVAETrainConfig(**{**BASE, **kw}), device="cpu",
                           log=NullLogger())


@pytest.fixture(scope="module")
def served(ds):
    """(model, the fold's arguments) of a one-epoch run."""
    res = _train(ds)
    tr = ds.train_idx
    rows = lambda a: torch.as_tensor(a[tr], dtype=torch.int64)  # noqa: E731
    params = {"vae": res.model.state_dict(),
              "gp": {k: v.detach() for k, v in res.gp_params.items()}}
    return res.model, (params, None, torch.from_numpy(ds.images[tr]), rows(ds.object_ids),
                       rows(ds.view_ids))


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


def _subtree(spans, i):
    out, todo = [], [i]
    while todo:
        k = todo.pop()
        out.append(k)
        todo += _children(spans, k)
    return out


def test_off_a_span_is_the_shared_null_context_and_records_nothing():
    t = Tracer()
    assert t.span("a") is t.span("b") is timers._NULL
    with t.span("a"), t.span("b"):
        t.count("c")
    assert t.read("site", int, torch.tensor(3)) == 3
    assert t.take() == [] and t.counts == {"c": 1, "host_sync": 1}


def test_nested_spans_record_parents_self_time_and_credited_counts():
    t = Tracer()
    t.set_tracing(True)
    with t.span("root"):
        t.count("x")
        with t.span("a"):
            t.count("x", 2)
            with t.span("leaf"):
                t.count("y")
        with t.span("b"):
            assert t.read("guard", bool, torch.tensor(True)) is True
    spans = t.take()
    assert [(s.name, s.parent) for s in spans] == [
        ("root", -1), ("a", 0), ("leaf", 1), ("b", 0), ("sync.guard", 3)]
    assert [s.counts for s in spans] == [{"x": 1}, {"x": 2}, {"y": 1}, {}, {"host_sync": 1}]
    assert t.counts == {"x": 3, "y": 1, "host_sync": 1}
    own = self_ns(spans)
    length = [s.end_ns - s.start_ns for s in spans]
    assert own[0] == length[0] - length[1] - length[3]
    assert own[1] == length[1] - length[2] and own[3] == length[3] - length[4]
    assert own[2] == length[2] and all(v >= 0 for v in own)
    assert all(s.start_ns <= s.end_ns for s in spans) and t.take() == []


def test_a_tally_holds_its_counts_back_from_the_counters_and_the_spans():
    """What is counted inside tally() is handed over as a dict and reaches
    neither the counters nor the open span; after it, counting is as
    before (a captured CUDA graph's step credits its tallies on replay)."""
    t = Tracer()
    t.set_tracing(True)
    with t.span("step"):
        t.count("x")
        with t.tally() as held:
            t.count("x", 2)
            t.count("y")
        t.count("x")
    (step,) = t.take()
    assert held == {"x": 2, "y": 1}
    assert step.counts == {"x": 2} and t.counts == {"x": 2}


def test_the_span_list_is_bounded_and_take_refuses_open_spans():
    t = Tracer(limit=2)
    t.set_tracing(True)
    with t.span("a"):
        with t.span("b"), t.span("dropped"):
            t.count("n")
        with pytest.raises(RuntimeError, match="open"):
            t.take()
    assert t.dropped == 1
    spans = t.take()
    assert [s.name for s in spans] == ["a", "b"] and spans[1].counts == {"n": 1}
    assert t.dropped == 0


def test_phase_timer_opens_a_span_per_phase(tracing):
    timer = PhaseTimer("cpu")
    with timer.phase("A"):
        with timers.span("inner"):
            pass
    with pytest.raises(KeyError), timer.phase("B"):
        raise KeyError("x")
    spans = timers.take()
    assert [(s.name, s.parent) for s in spans] == [("A", -1), ("inner", 0), ("B", -1)]
    assert set(timer.reset()) == {"A", "B"}


def test_a_traced_epoch_splits_each_step(ds, tracing):
    res = _train(ds)
    spans = timers.take()
    names = [s.name for s in spans]
    n_steps = tg.num_batches(len(ds.train_idx), BASE["batch_size"])
    roots = [s.name for s in spans if s.parent == -1]
    assert roots[0] == "setup" and [r for r in roots if r in PHASES] == list(PHASES)
    setup = names.index("setup")
    assert {spans[j].name for j in _children(spans, setup)} == {
        "setup.model", "setup.gp", "setup.data", "setup.object_kernel", "setup.loop"}
    steps = [i for i, n in enumerate(names) if n == "C.step"]
    assert len(steps) == n_steps == res.optimizers["vae"].steps
    for i in steps:
        assert names[spans[i].parent] == "C_minibatch"
        assert [names[j] for j in _children(spans, i)] == ["C.forward", "C.backward", "C.optim"]
        under = sorted(_subtree(spans, i))
        syncs = [(names[j], names[spans[j].parent]) for j in under
                 if names[j].startswith("sync.")]
        assert syncs == []  # σ_y is filled on the device, both guards decide there
        assert sum(spans[j].counts.get("host_sync", 0) for j in under) == 0
    # the epoch record's reads, after the phases
    assert [n for n in roots if n.startswith("sync.")] == [
        "sync.metrics", "sync.nll", "sync.v_sig", "sync.v_noise", "sync.oos_mse"]


def test_tracing_changes_no_number_of_the_run(ds):
    timers.take()
    runs = {}
    for on in (False, True):
        timers.set_tracing(on)
        try:
            runs[on] = _train(ds, epochs=2)
        finally:
            timers.set_tracing(False)
    assert timers.take() != []
    off, on = runs[False], runs[True]
    for k, v in off.model.state_dict().items():
        assert torch.equal(v, on.model.state_dict()[k]), k
    for k, v in off.gp_params.items():
        assert torch.equal(v, on.gp_params[k]), k
    for a, b in zip(off.history, on.history):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if not k.startswith("sec_")} == {
            k: v for k, v in b.items() if not k.startswith("sec_")}


def test_host_syncs_are_counted_with_tracing_off(ds):
    before = timers.TRACER.counts.get("host_sync", 0)
    _train(ds)
    # the plan's three copies and the epoch record's five reads; a step
    # makes none
    assert timers.TRACER.counts["host_sync"] - before == 3 + 5


def test_predict_images_replies_alike_and_splits_each_request(served, tracing):
    model, fold = served
    state = build_server_state(model, *fold)
    timers.take()
    d, q = torch.tensor([0, 3, 5]), torch.tensor([1, 1, 7])
    traced = predict_images(model, state, d, q)
    spans = timers.take()
    timers.set_tracing(False)
    assert torch.equal(traced, predict_images(model, state, d, q))
    assert timers.take() == []
    assert [(s.name, s.parent) for s in spans] == [
        ("serve.predict", -1), ("serve.gp", 0), ("serve.decode", 0)]


def test_the_fold_splits_into_encode_factorize_and_core(served, tracing):
    model, fold = served
    build_server_state(model, *fold)
    spans = timers.take()
    assert [(s.name, s.parent) for s in spans] == [
        ("fold", -1), ("fold.encode", 0), ("fold.factorize", 0), ("fold.core", 0)]


def test_a_recording_profiler_records_spans_and_tracing_annotates_its_trace():
    """Under torch.profiler a span is recorded with tracing off; with tracing
    on it is also a user annotation of the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile

    timers.take()
    names = {}
    for on in (False, True):
        timers.set_tracing(on)
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with timers.span("outer"):
                    with timers.span("inner"):
                        torch.ones(4).sum()
        finally:
            timers.set_tracing(False)
        spans = timers.take()
        assert [(s.name, s.parent) for s in spans] == [("outer", -1), ("inner", 0)]
        names[on] = collections.Counter(
            e.name for e in prof.events() if e.name in ("outer", "inner"))
    assert names == {False: {}, True: {"outer": 1, "inner": 1}}
    assert timers.span("after") is timers._NULL

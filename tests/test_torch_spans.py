"""The port's host spans (profiling.span, profiling.spans) in the training
loop, on the CPU, and the benchmark's readers of them: nothing recorded
and nothing changed without a profiler; under one, one hgnn2.graph.replay
and one hgnn2.schedule a step, one hgnn2.scan a shape group and one
hgnn2.fetch and one hgnn2.epoch an epoch, nested as run, as CPU ops of the
profiler that are not user annotations; the store's bound; the readers'
values, and none where spans were dropped past the bound. The file
imports the port and the benchmark only.

    python -m pytest tests/test_torch_spans.py -q
"""

from __future__ import annotations

from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run, tracing
from hgnn2_torch import profiling
from hgnn2_torch.data import batching, qm9
from hgnn2_torch.nn import models
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.config import OptimConfig

EPOCHS = 2
NAMES = ("hgnn2.epoch", "hgnn2.scan", "hgnn2.graph.replay", "hgnn2.schedule",
         "hgnn2.fetch")
PARENT = {"hgnn2.epoch": None, "hgnn2.scan": "hgnn2.epoch",
          "hgnn2.graph.replay": "hgnn2.scan", "hgnn2.schedule": "hgnn2.scan",
          "hgnn2.fetch": "hgnn2.epoch"}


@pytest.fixture
def fresh(monkeypatch):
    """An empty store of span records, as in a process never profiled."""
    monkeypatch.setattr(profiling, "_session", profiling._Session())


def _trainer():
    """A GNNSimple L=2, h=2 over 96 molecules, 16 a step, in stacked shape
    groups, with its scanned epoch; the same weights every call."""
    recs = qm9.synthetic_qm9_like(96, seed=5)
    ys = np.array([r.y[0] for r in recs])
    batches = list(batching.DenseLoader(recs, 16, task=0, device="cpu"))
    model = models.GNNSimple(in_features=5, n_features=2, n_layers=2,
                             generator=torch.Generator().manual_seed(0))
    opt, sched = optim.build_optimizer(
        OptimConfig(optim="adamax", lr=1e-3, lr_damping=0.5, epoch_step=1),
        len(batches), model.parameters())
    groups = train.group_stacked_batches(batches)
    fn = train.make_scanned_epoch(model, opt, sched, "regression",
                                  float(ys.mean()), float(ys.std()))
    return groups, fn, model


def _epochs(groups, fn, n: int = EPOCHS) -> list[dict]:
    rng = np.random.default_rng(3)
    return [train.run_epoch_scanned(groups, fn, rng) for _ in range(n)]


def _profiled(n: int = EPOCHS):
    groups, fn, _ = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _epochs(groups, fn, n)
    return groups, prof


def test_span_off_is_a_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("a") is profiling.span("b") is profiling._OFF


def test_no_profiler_records_nothing_and_changes_nothing(fresh, monkeypatch):
    groups, fn, model = _trainer()
    off = _epochs(groups, fn)
    assert profiling.spans() == [] and profiling.dropped_spans() == 0
    state_off = {k: v.clone() for k, v in model.state_dict().items()}
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    groups, fn, model = _trainer()
    on = _epochs(groups, fn)
    assert len(profiling.spans()) > 0
    assert on == off
    for k, v in model.state_dict().items():
        assert torch.equal(v, state_off[k]), k


def test_one_span_a_step_a_group_and_an_epoch(fresh):
    groups, _ = _profiled()
    steps = sum(train._group_size(g) for g in groups)
    names = [s.name for s in profiling.spans()]
    assert {n: names.count(n) for n in NAMES} == {
        "hgnn2.epoch": EPOCHS, "hgnn2.fetch": EPOCHS,
        "hgnn2.scan": EPOCHS * len(groups),
        "hgnn2.graph.replay": EPOCHS * steps, "hgnn2.schedule": EPOCHS * steps}
    assert profiling.dropped_spans() == 0


def test_each_span_lies_inside_its_parent(fresh):
    _profiled()
    recs = profiling.spans()
    for s in recs:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        want = PARENT[s.name]
        if want is None:
            assert s.parent is None
            continue
        p = recs[s.parent]
        assert p.name == want
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_spans_are_cpu_ops_of_the_profiler_not_annotations(fresh):
    _, prof = _profiled()
    ours = [e for e in prof.events() if e.name.startswith("hgnn2.")]
    assert {e.name for e in ours} == set(NAMES)
    for e in ours:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation
    names = [s.name for s in profiling.spans()]
    assert sorted(e.name for e in ours) == sorted(names)


def test_a_new_session_replaces_the_last_ones_records(fresh):
    _profiled(2)
    first = len(profiling.spans())
    _profiled(1)
    assert 0 < len(profiling.spans()) < first
    assert [s.name for s in profiling.spans()].count("hgnn2.epoch") == 1


def test_the_store_keeps_its_bound(fresh, monkeypatch):
    _profiled()
    total = len(profiling.spans())
    monkeypatch.setattr(profiling, "SPAN_LIMIT", 7)
    _profiled()
    recs = profiling.spans()
    assert len(recs) == 7
    assert profiling.dropped_spans() == total - 7
    assert all(s.parent is None or s.parent < i for i, s in enumerate(recs))


def test_the_breakdown_labels_a_gap_with_a_port_span(fresh):
    """The slice's idle gaps between replays (device work standing in for
    each replay's interval) are put to the port's spans there."""
    groups, fn, _ = _trainer()
    with tracing.Slice(True) as sl:
        _epochs(groups, fn)
    events = list(sl.prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    replays = [e for e in events if e.name == "hgnn2.graph.replay"]
    device = [NS(name="kernel", time_range=e.time_range, device_type=cuda,
                 is_user_annotation=False) for e in replays]
    s = tracing.summarize(events + device, [], units=len(replays))
    labels = [label for label, _ in s.idle_gaps]
    assert any(label.startswith("host: hgnn2.") for label in labels), labels
    assert not any("hgnn2." in name for name, _ in s.device_ops)


READERS = ("train.replay_host_us", "train.between_replays_us",
           "train.fetch_wait_pct")


def _rec(name, start_us, end_us, parent=None):
    return profiling.SpanRecord(name, int(start_us * 1e3), int(end_us * 1e3),
                                parent)


# two epochs: the first of one group of two steps, the second of two
# groups of one step; a fetch ends each
HANDMADE = [
    _rec("hgnn2.epoch", 0, 100),
    _rec("hgnn2.scan", 1, 61, 0),
    _rec("hgnn2.graph.replay", 2, 22, 1),
    _rec("hgnn2.schedule", 22, 25, 1),
    _rec("hgnn2.graph.replay", 25, 55, 1),
    _rec("hgnn2.schedule", 55, 58, 1),
    _rec("hgnn2.fetch", 62, 99, 0),
    _rec("hgnn2.epoch", 200, 250),
    _rec("hgnn2.scan", 200, 220, 7),
    _rec("hgnn2.graph.replay", 201, 211, 8),
    _rec("hgnn2.scan", 220, 240, 7),
    _rec("hgnn2.graph.replay", 221, 239, 10),
    _rec("hgnn2.fetch", 240, 250, 7),
    # a replay outside any scan (make_train_step's) counts in the mean only
    _rec("hgnn2.graph.replay", 300, 302),
]
WANT = {"train.replay_host_us": (20 + 30 + 10 + 18 + 2) / 5,
        "train.between_replays_us": ((60 + 20 + 20) - (20 + 30 + 10 + 18)) / 4,
        "train.fetch_wait_pct": 100.0 * (37 + 10) / (100 + 50)}


VIEW = NS(trace=None, work=None, spans={}, cell={}, cfg={})


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_spans(name, fresh):
    assert run.reader(name)(VIEW) is None


@pytest.mark.parametrize("cut", ["7", "second_epoch"])
@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_past_the_bound(name, cut, fresh, monkeypatch):
    """Spans dropped past SPAN_LIMIT (7, or just after the second epoch's
    first scan opened) leave scans without their later replays and an
    epoch without its fetch: no reading, though whole ones were kept."""
    limit = 7
    if cut == "second_epoch":
        _profiled()
        names = [s.name for s in profiling.spans()]
        limit = names.index("hgnn2.epoch", 1) + 2
    monkeypatch.setattr(profiling, "SPAN_LIMIT", limit)
    _profiled()
    assert len(profiling.spans()) == limit and profiling.dropped_spans() > 0
    assert run.reader(name)(VIEW) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_on_handmade_spans(name, fresh, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(HANDMADE))
    assert run.reader(name)(VIEW) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_profiled_run(name, fresh):
    groups, _ = _profiled()
    value = run.reader(name)(VIEW)
    assert value is not None and value > 0
    if name == "train.fetch_wait_pct":
        assert value < 100

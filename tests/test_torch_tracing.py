"""The port's host spans (``repro_torch.runtime.tracing``) in ``cg.run``:
absent with no profiler recording, counted and nested under one, and
without effect on what ``cg.run`` returns. CPU, the plain engine, the
storm-tw24 deployment's CG settings at a small slot."""
import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import cg
from repro_torch.runtime import tracing

SLOTS = 3
# storm-tw24: 24 workers (two at 30%), α 20, 8 sources merged every block
# of 128, W-Choices, 16 moves a slot, ρ 0.8; the slot cut to 1,024
CFG = cg.CGConfig(n_workers=24, alpha=20, eps=0.01, slot_len=1024,
                  max_moves_per_slot=16, block_size=128, n_sources=8,
                  sync_every=1, hh_scheme="WCHOICES", engine="auto")
_REL = np.array([0.3, 0.3] + [1.0] * 22)
CAPS = torch.tensor(_REL / _REL.sum() / 0.8, dtype=torch.float32)


def _keys(seed=0, n_keys=20_000, z=0.8):
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_keys + 1, dtype=np.float64) ** -z
    return torch.from_numpy(rng.choice(n_keys, size=SLOTS * CFG.slot_len,
                                       p=p / p.sum()).astype(np.int32))


def _run():
    return cg.run(CFG, _keys(), CAPS, device="cpu")


def _profiled_run():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _run()
    return res, prof


@pytest.fixture(autouse=True)
def _empty_table():
    tracing.reset()
    yield
    tracing.reset()


def test_profiler_flag_follows_the_profiler():
    """The one flag a span reads is set while ``torch.profiler.profile``
    records, and clear before and after."""
    assert not autograd_profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled
    assert not autograd_profiler._is_profiler_enabled


def test_no_profiler_no_spans(monkeypatch):
    entered = []
    enter = autograd_profiler.record_function.__enter__

    def counting_enter(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(autograd_profiler.record_function, "__enter__",
                        counting_enter)
    _run()
    assert entered == []
    assert tracing.totals() == {}


def test_spans_counted_under_the_profiler():
    _profiled_run()
    t = tracing.totals()
    assert set(t) == {"cg.run", "cg.route", "cg.delegate"}
    assert t["cg.run"].calls == 1
    assert t["cg.route"].calls == SLOTS
    assert t["cg.delegate"].calls == SLOTS
    # the leaves open no span: their self time is their wall time
    for name in ("cg.route", "cg.delegate"):
        assert t[name].self_ns == t[name].wall_ns > 0


def test_spans_nest_on_the_profiler_timeline():
    _, prof = _profiled_run()
    ev = {}
    for e in prof.events():
        if e.name.startswith("cg."):
            ev.setdefault(e.name, []).append(e.time_range)
    (outer,) = ev["cg.run"]
    assert len(ev["cg.route"]) == len(ev["cg.delegate"]) == SLOTS
    for r in ev["cg.route"] + ev["cg.delegate"]:
        assert outer.start <= r.start <= r.end <= outer.end


def test_self_time_plus_children_is_the_total():
    _profiled_run()
    t = tracing.totals()
    assert t["cg.run"].self_ns > 0
    assert (t["cg.run"].self_ns + t["cg.route"].wall_ns
            + t["cg.delegate"].wall_ns) == t["cg.run"].wall_ns


def test_reset_clears_the_table():
    _profiled_run()
    assert tracing.totals()
    tracing.reset()
    assert tracing.totals() == {}


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if x is None:
        return []
    return [y for v in x for y in _leaves(v)]


def test_outputs_identical_with_and_without_the_profiler():
    plain = _run()
    traced, _ = _profiled_run()
    assert torch.equal(plain.assignment, traced.assignment)
    assert torch.equal(plain.vw_assignment, traced.vw_assignment)
    a, b = _leaves(plain.state), _leaves(traced.state)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for f in plain.state._fields:
        assert (getattr(plain.state, f) is None) == \
            (getattr(traced.state, f) is None), f

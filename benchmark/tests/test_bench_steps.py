"""The step clock reads every step's pair of events once it has completed,
without a sync, and reuses the pairs: the live events stay few however
many steps a window holds. Fake events stand in for the card's."""

import torch

import tiny_cells  # noqa: F401  (puts the benchmark on sys.path)
from benchlib import steps


class FakeEvent:
    clock = 0
    made = []

    def __init__(self, enable_timing=True):
        self.at, self.done = None, False
        FakeEvent.made.append(self)

    def record(self):
        FakeEvent.clock += 1
        self.at, self.done = FakeEvent.clock, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return float(end.at - self.at)


def _complete_all():
    for ev in FakeEvent.made:
        ev.done = True


def test_pairs_are_read_as_they_complete_and_reused(monkeypatch):
    FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", _complete_all)
    clock = steps.StepClock(torch.device("cuda"))
    step = clock.wrap(lambda: _complete_all())
    for _ in range(1000):
        step()
    # each step's pair completes by the next step: at most two pairs live
    assert len(FakeEvent.made) <= 6
    assert clock.count == 1000
    ms = clock.times_ms()
    assert len(ms) == 1000 and all(m == 1.0 for m in ms)
    clock.reset()
    assert clock.count == 0 and clock.times_ms() == []


def test_pending_pairs_wait_for_the_sync(monkeypatch):
    FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", _complete_all)
    clock = steps.StepClock(torch.device("cuda"))
    step = clock.wrap(lambda: None)          # nothing completes on its own
    for _ in range(5):
        step()
    assert len(clock._pending) == 5
    assert len(clock.times_ms()) == 5 and not clock._pending

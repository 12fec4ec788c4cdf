"""The window's arithmetic on a fake clock: the rate counts every step of
every episode over the whole window, the tail is taken over every step,
and the window closes at the end of the episode in progress."""

from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np

from phdbench import harness


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class FakeCell:
    """Episodes of T steps whose step times the test fixes."""

    def __init__(self, clock, step_s):
        self.clock, self.step_s = clock, step_s
        self.T = len(step_s[0])
        self.probe = SimpleNamespace(host_s=0.0, steps=0)
        self.record = nullcontext
        self.episodes = 0

    def sync(self):
        pass

    def episode(self, e, seed, step_ms):
        for s in self.step_s[e]:
            self.clock.t += s
            step_ms.append(s * 1e3)
            self.probe.host_s += 0.004       # host time issuing the step
        self.probe.steps += self.T
        self.episodes += 1
        return 0


def test_window_closes_at_an_episode_end(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    rng = np.random.default_rng(0)
    step_s = [rng.uniform(0.01, 0.05, 100) for _ in range(10)]
    cell = FakeCell(clock, step_s)
    win = harness.Cell.window(cell, seed=1, seconds=5.0)
    spent = np.cumsum([s.sum() for s in step_s])
    n_ep = int(np.searchsorted(spent, 5.0) + 1)   # the episode that passes 5 s
    assert win["episodes"] == n_ep == cell.episodes
    assert win["steps"] == 100 * n_ep
    assert np.isclose(win["seconds"], spent[n_ep - 1])
    assert win["seconds"] >= 5.0
    rate = harness.load_reader("steps_per_s")({"window": win})
    assert np.isclose(rate, 100 * n_ep / spent[n_ep - 1])
    p95 = harness.load_reader("step_ms_p95")({"window": win})
    every = np.concatenate(step_s[:n_ep]) * 1e3
    assert np.isclose(p95, np.percentile(every, 95))
    host = harness.load_reader("runner.host_ms")({"window": win})
    assert np.isclose(host, 4.0)


def test_replay_has_no_tail():
    win = {"step_ms": [], "steps": 10, "seconds": 1.0}
    assert harness.load_reader("step_ms_p95")({"window": win}) is None


def test_episode_seeds_and_checked_steps():
    assert harness.episode_seed(2 ** 31 + 5, 3) == (2 ** 31 + 5) * 1000 + 3
    a = harness.check_steps(2 ** 31 + 5, 0, 331, 2)
    assert a == harness.check_steps(2 ** 31 + 5, 0, 331, 2)
    assert 0 in a and len(a) == 3 and max(a) < 331
    b = harness.check_steps(2 ** 31 + 5, 1, 331, 1)
    assert 0 not in b and len(b) == 1


def test_untraced_tail_leaves_out_the_profiled_steps():
    traced = [50.0] * 40                      # steps under the profiler
    rest = list(np.linspace(10.0, 12.0, 200))
    win = {"step_ms": traced + rest, "steps": 240, "seconds": 3.0}
    read = harness.load_reader("runner.step_ms_p95.host_paced")
    assert np.isclose(read({"window": win, "traced": {"steps": 40}}),
                      np.percentile(rest, 95))
    assert np.isclose(read({"window": win, "traced": None}),
                      np.percentile(traced + rest, 95))
    assert read({"window": {"step_ms": [], "steps": 10, "seconds": 1.0},
                 "traced": None}) is None

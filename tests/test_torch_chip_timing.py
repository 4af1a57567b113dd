"""``chip_smoke.device_ms``'s guard against lost profiler records, on the CPU.

The profiler is replaced by a stand-in that hands out given windows (each
one or more kinds of kernel, a count of records and their summed µs); a
call's time is each kind's mean duration times its count per call (its
records over the 50 calls, rounded), and the guard must take a reading only
from two windows that have every kind at the count per call of the fullest
window seen, whose times agree within 20% and are at least the floor, and
must raise where no such pair comes.  A window that reads no record does
not count toward the 8 windows, up to 24 windows in all."""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


class _Event:
    def __init__(self, key, count, us):
        self.count, self.us, self.key = count, us, key
        self.device_type = cs.DeviceType.CUDA


@pytest.fixture
def windows(monkeypatch):
    """Set the windows the stand-in profiler hands out, one per ``profile``."""
    queue = []

    class Profile:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            window = queue.pop(0)
            kinds = window if isinstance(window, list) else [window]
            self.events = [_Event(f"kernel{i}", *k) for i, k in enumerate(kinds)]
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(cs, "profile", Profile)
    monkeypatch.setattr(cs, "device_us", lambda e: e.us)
    monkeypatch.setattr(cs.torch.cuda, "synchronize", lambda: None)
    return queue


@pytest.mark.parametrize("given, floor, want", [
    ([(50, 1500.0), (50, 1510.0)], 0.0, 0.03010),
    # the first records of a window lost: each kind's mean times its count per call
    ([(48, 130.0), (48, 130.5)], 0.0, (130.0 / 48 + 130.5 / 48) / 2e3),
    ([(9300, 46100.0), (9297, 46200.0)], 0.0, (46100 / 9300 + 46200 / 9297) * 186 / 2e3),
    # a window under the floor lost records: measured again
    ([(50, 472.0), (50, 1500.0), (50, 1530.0)], 0.019, 0.03030),
    # windows that lost one kind's records do not pair once a whole window
    # has been seen
    ([[(50, 1250.0), (50, 250.0)], [(50, 250.0)], [(50, 250.0)], [(50, 1260.0), (50, 250.0)]],
     0.0, 0.03010),
    # a flush and a B1 call (three kinds): windows that lost a few records
    # pair; a whole window read at half its time is under the floor
    ([[(47, 47 * 25.0), (47, 47 * 13.0), (48, 48 * 4.5)],
      [(50, 50 * 12.0), (50, 50 * 6.0), (50, 50 * 2.2)],
      [(50, 50 * 25.0), (49, 49 * 13.0), (50, 50 * 4.5)]], 0.026, 0.0425),
    # times more than 20% apart are passed over
    ([(50, 1500.0), (50, 1900.0), (50, 1550.0)], 0.0, 0.03050),
    # half of the windows read no record: they do not count toward the 8, so
    # the fifth window that reads records pairs with the fourth, in the tenth
    # window in all
    ([(0, 0.0), (50, 1500.0), (0, 0.0), (50, 2500.0), (0, 0.0), (50, 4000.0), (0, 0.0),
      (50, 6500.0), (0, 0.0), (50, 6600.0)], 0.0, 0.13100),
])
def test_device_ms_takes_two_whole_agreeing_windows(windows, given, floor, want):
    windows.extend(given)
    assert cs.device_ms(lambda: None, floor, iters=50, warmup=0) == pytest.approx(want)


@pytest.mark.parametrize("given, floor", [
    ([(50, 472.0)] * 8, 0.019),                              # every window under the floor
    ([(50, 100.0 * 2 ** i) for i in range(8)], 0.0),         # no two agree
    ([(0, 0.0)] * 24, 0.0),                                  # nothing recorded, 3 x 8
    ([[(50, 1250.0), (50, 250.0)]] + [[(50, 250.0)]] * 7, 0.0),  # one whole window only
])
def test_device_ms_raises_without_a_whole_pair(windows, given, floor):
    windows.extend(given)
    with pytest.raises(AssertionError, match="no two whole windows"):
        cs.device_ms(lambda: None, floor, iters=50, warmup=0)
    assert windows == []        # every window handed out was read, and no more


def test_device_ms_says_how_many_windows_were_empty(windows):
    """Empty windows among whole ones that never agree: 8 windows that read
    records and 5 empty ones, then the error names the 5."""
    windows.extend([(0, 0.0)] * 5 + [(50, 100.0 * 2 ** i) for i in range(8)])
    with pytest.raises(AssertionError, match="among 8 that read records; 5 of 13 windows "
                                             "read no CUDA record"):
        cs.device_ms(lambda: None, 0.0, iters=50, warmup=0)

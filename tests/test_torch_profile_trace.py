"""chip_smoke.py's profile phases read a step's trace from the profiler's
raw kineto events (`trace_events`) instead of torch's parsed FunctionEvents.
On the CPU (no device events) the two must give the same event tree: the
same events in the same order, each with the same name, start, end, CPU
parent and number of CPU children (torch's tree build and its merge of a
lone child of the same name), and the same per-name event counts as
key_averages.  On the card, scripts/torch_profile_cost.py checks the
profile phase's printed fields equal to those read from the parsed
events."""
import os
import sys
from collections import Counter

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from libyafaray_tpu_torch.scene.session import render_scene  # noqa: E402


@pytest.fixture(scope="module")
def profiled():
    from torch.profiler import ProfilerActivity, profile

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s = chip_smoke.scene_at(chip_smoke.SURFACES,
                                dict(width=8, height=8, AA_minsamples=1))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            render_scene(s, device="cpu")
    finally:
        torch.set_num_threads(n)
    return prof


def test_trace_events_give_torchs_event_tree(profiled):
    mine = chip_smoke.trace_events(profiled)
    theirs = list(profiled.events())
    assert len(mine) == len(theirs) > 1000
    for a, b in zip(mine, theirs):
        assert a.name == b.name
        assert a.start == b.time_range.start and a.end == b.time_range.end
        assert (a.parent.name if a.parent else None) == (
            b.cpu_parent.name if b.cpu_parent else None)
        assert len(a.children) == len(b.cpu_children)


def test_trace_events_count_ops_as_key_averages(profiled):
    mine = Counter(e.name for e in chip_smoke.trace_events(profiled))
    theirs = {e.key: e.count for e in profiled.key_averages()}
    assert mine == Counter(theirs)
    # no device events on the CPU: nothing measured
    assert chip_smoke.trace_summary(chip_smoke.trace_events(profiled),
                                    ("kernel",), None) == dict(
        device_busy_ms="not measured")

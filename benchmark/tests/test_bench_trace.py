"""Reading a profile: device busy time, the top device operations and the
idle gaps, on hand-made events."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, dev, a, b):
    return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=a, end=b))


EVENTS = [
    ev("unit", CPU, 0, 1000), ev("write", CPU, 500, 1000), ev("simrank", CPU, 0, 400),
    ev("simrank", CUDA, 100, 450),             # the device side of a host span: not work
    ev("spmv", CUDA, 100, 200), ev("spmv", CUDA, 150, 300), ev("copy", CUDA, 350, 400),
]
SPANS = dict.fromkeys(["unit", "write", "simrank"])


def test_busy_is_the_union_of_device_work():
    iv = trace.device_intervals(EVENTS, SPANS)
    assert iv == [(100, 300), (350, 400)]
    assert trace.busy_s(iv) == pytest.approx(250e-6)


def test_top_ops_sum_by_name_and_skip_host_spans():
    assert trace.top_device_ops(EVENTS, SPANS) == [["spmv", 250e-6], ["copy", 50e-6]]


def test_idle_gaps_named_by_the_innermost_open_span():
    gaps = trace.idle_gaps(EVENTS, trace.device_intervals(EVENTS, SPANS), SPANS)
    assert gaps[0] == ["write", pytest.approx(600e-6)]
    assert ["simrank", pytest.approx(100e-6)] in gaps and ["simrank", pytest.approx(50e-6)] in gaps

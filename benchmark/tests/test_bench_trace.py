"""The profiler's events reduced by hand: busy time is the union of device
intervals, copies count as busy but not as launches, and each idle gap is
named by the innermost host call running at its midpoint."""

import pytest
import torch

from benchmark.trace import reduce_events

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, start, dur, name, dev):
        self.args = (start, dur, name, dev)

    def start_ns(self):
        return self.args[0]

    def duration_ns(self):
        return self.args[1]

    def name(self):
        return self.args[2]

    def device_type(self):
        return self.args[3]


def test_reduce_by_hand():
    events = [
        Event(0, 100, "conv3x3_tc_kernel<64, 2>", CUDA),
        Event(50, 100, "flash_fwd_wgmma", CUDA),     # overlaps the first: union 0..150
        Event(200, 50, "flash_fwd_wgmma", CUDA),
        Event(400, 10, "Memcpy HtoD (Pageable -> Device)", CUDA),
        Event(0, 1000, "cudaStreamSynchronize", CPU),
        Event(160, 30, "cudaLaunchKernel", CPU),      # covers the 150..200 gap's midpoint
    ]
    tr = reduce_events(events, 1e-6)
    assert tr.busy_s == pytest.approx(210e-9)
    assert tr.launches() == 3
    assert tr.kernel_time("flash_fwd") == (pytest.approx(150e-9), 2)
    assert tr.idle_by_host == {"cudaLaunchKernel": pytest.approx(50e-9),
                               "cudaStreamSynchronize": pytest.approx(150e-9)}
    assert tr.top_ops(1) == [["flash_fwd_wgmma", pytest.approx(150e-9)]]

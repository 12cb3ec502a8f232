"""The trace reduction: the union of device intervals, the idle gaps and
what the host was doing in them."""

from perfbench import trace


class _Event:
    def __init__(self, name, device, start_s, seconds):
        self._name, self._device = name, device
        self._start, self._duration = int(start_s * 1e9), int(seconds * 1e9)

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType." + self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._duration


def test_reduce():
    events = [
        _Event("bench.window", "CPU", 0.0, 10.0),
        _Event("bench.sync", "CPU", 0.0, 10.0),
        _Event("bench.sync", "CUDA", 0.5, 9.0),  # the span's shadow on the device: no work
        _Event("kernel_a", "CUDA", 1.0, 1.0),
        _Event("kernel_b", "CUDA", 1.5, 1.0),  # overlaps kernel_a: counted once
        _Event("memcpy", "CUDA", 9.5, 1.0),  # runs past the window: clipped
        _Event("aten::copy_", "CPU", 5.0, 2.0),
    ]
    found = trace.reduce(events)
    assert found["window_s"] == 10.0
    assert abs(found["busy_s"] - 2.0) < 1e-9
    assert dict(found["device_ops"]) == {"kernel_a": 1.0, "kernel_b": 1.0, "memcpy": 0.5}
    gaps = dict(found["idle_gaps"])
    assert abs(gaps["aten::copy_"] - 7.0) < 1e-9 and abs(gaps["bench.sync"] - 1.0) < 1e-9
    assert abs(sum(gaps.values()) + found["busy_s"] - found["window_s"]) < 1e-9


def test_no_window_no_reading():
    assert trace.reduce([_Event("kernel_a", "CUDA", 0.0, 1.0)]) is None

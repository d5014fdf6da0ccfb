"""The device's idle share over the profiled units: 1 - busy/window, where
busy is the union of the profiler's device intervals, in %."""


def read(rec):
    busy, window = rec["busy_s"], rec["trace_window_s"]
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)

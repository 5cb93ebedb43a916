"""The closed loop's close (``harness.drive``): with ``trace`` the device
trace is read on the loop's thread as the window closes, and that read can
outlast ``late_s``.  The window's last batches are awaited ``late_s`` past
the end of the read, so the read makes no answer late."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gatebench_tiny import GATED, harness, tiny_cell  # noqa: E402

SEED = 2**31 + 29
LATE_S = 0.5
READ_S = 1.0  # longer than LATE_S: awaited from the close, every wait would be 0


class _Handle:
    """A front-end handle that keeps the timeout of each wait on it."""

    def __init__(self, handle, timeouts: list):
        self._handle, self._timeouts = handle, timeouts

    def result(self, timeout=None):
        self._timeouts.append(timeout)
        return self._handle.result(timeout=timeout)

    def __getattr__(self, name):
        return getattr(self._handle, name)


class _Front:
    def __init__(self, front, timeouts: list):
        self._front, self._timeouts = front, timeouts

    def submit(self, *args, **kwargs):
        return _Handle(self._front.submit(*args, **kwargs), self._timeouts)

    def __getattr__(self, name):
        return getattr(self._front, name)


def test_late_answers_are_awaited_from_the_end_of_the_trace_read(monkeypatch):
    from repro_torch import obs

    totals = harness._registry_totals
    reads = []

    def slow_read(reg):  # the close's read (the second) outlasts LATE_S
        reads.append(None)
        if len(reads) == 2:
            import time
            time.sleep(READ_S)
        return totals(reg)

    monkeypatch.setattr(harness, "_registry_totals", slow_read)
    dep = harness.setup(tiny_cell(GATED[0], n=800), SEED, "cpu")
    timeouts = []
    dep.frontend = _Front(dep.frontend, timeouts)
    try:
        win = harness.drive(dep, 0.3, trace=True, registry=obs.default_registry(),
                            late_s=LATE_S)
    finally:
        dep.close()
    assert len(reads) == 2
    assert win.closed_at - win.t1 >= READ_S
    after = [t for t in timeouts if t is not None]
    assert after, "no request was awaited past the close"
    assert max(after) > LATE_S / 2
    assert win.requests.ok.all()

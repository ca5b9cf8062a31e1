"""Helpers of the port's tests that import without jax: the decode ring's
work function for the ring tests (the ring's spawned workers import this
module to run it), and a hang guard for the test files that start
processes and threads or run the release end to end."""

import contextlib
import faulthandler
import signal
import time

import numpy as np
import pytest

FILE_TIMEOUT = 600.0    # s a guarded file may take (each takes < 90 s alone)
HARD_GRACE = 60.0       # s more before a hang that holds the interpreter
                        # ends the worker


def synth_frames(payload):
    """(T, H, W, delay s) -> [T, H, W, 3] uint8 of 127 after ``delay``
    seconds: no work, so a run times the ring's transport alone; a delay on
    one job makes its result arrive after later ones."""
    t, h, w, delay = payload
    time.sleep(delay)
    return np.full((t, h, w, 3), 127, np.uint8)


@contextlib.contextmanager
def hang_guard(seconds: float, grace: float = HARD_GRACE):
    """Past ``seconds`` the main thread raises TimeoutError (SIGALRM, with
    every thread's stack on stderr); a hang that holds the interpreter past
    ``seconds + grace`` ends the process (faulthandler)."""
    def expired(signum, frame):
        faulthandler.dump_traceback(all_threads=True)
        raise TimeoutError(f"ran past {seconds:g} s (every thread's stack "
                           "is on stderr)")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(seconds + grace, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def file_hang_guard():
    """``hang_guard`` over a whole test file: a hang fails its file instead
    of stalling the whole run (under xdist a worker that ends is replaced,
    and the run goes on)."""
    with hang_guard(FILE_TIMEOUT):
        yield


@pytest.fixture(scope="module")
def few_torch_threads():
    """Two torch threads over a whole test file, the previous count after
    it: under the tier-1 run's 6 workers, torch's default of a thread a
    core oversubscribes the machine, and a training loop's waiting threads
    then slow it 10-15 times."""
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def test_synth_frames_shape_value_and_delay():
    t0 = time.perf_counter()
    out = synth_frames((3, 4, 5, 0.2))
    assert time.perf_counter() - t0 >= 0.2
    assert out.shape == (3, 4, 5, 3) and out.dtype == np.uint8
    assert (out == 127).all()


def test_hang_guard_breaks_a_wait_and_stands_down():
    with pytest.raises(TimeoutError, match="ran past 0.3 s"):
        with hang_guard(0.3):
            time.sleep(5.0)
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    with hang_guard(5.0):
        time.sleep(0.1)
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)

"""A time limit for the tests that start worlds of processes (the port's
parallel/world.py spawn, torch.multiprocessing.spawn with join=True). A
rank that never reaches its rendezvous or its collective leaves the test
waiting on it, and with it the xdist worker, until the suite's own clock
ends the run; under the limit the test fails with a TimeoutError that
names the limit, and the ranks are ended so that the worker can go on.

What it cannot do: the limit is a SIGALRM on the main thread, and Python
runs a signal handler only between bytecodes. A wait on processes (a
join, a select) returns to Python at once; a long C++ call, such as an
XLA compile, is ended only when it returns. Collects no tests."""

import functools
import multiprocessing
import signal
from contextlib import contextmanager

# Above the slowest of these tests alone (about 30 s on 8 CPU cores) times
# the slowdown of a busy suite, and below the suite's clock.
WORLD_LIMIT_S = 300


class _Expired(BaseException):
    """The alarm's exception on its way up the test. Not an Exception, so
    that no ``except OSError`` on the way (multiprocessing's wait is one)
    takes it for a failed call: time_limit turns it into TimeoutError."""


@contextmanager
def time_limit(seconds):
    """Raise TimeoutError in the main thread after ``seconds`` (whole
    seconds), once multiprocessing's children are ended. One limit at a
    time: an inner one replaces the one around it."""

    def expire(signum, frame):
        children = multiprocessing.active_children()
        for child in children:
            child.terminate()
        for child in children:
            child.join(5)
            if child.is_alive():
                child.kill()
                child.join()
        raise _Expired

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    except _Expired:
        raise TimeoutError(f"the test ran past its limit of {seconds} s") from None
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def world_limited(test):
    """``test`` under time_limit(WORLD_LIMIT_S); its signature, and so its
    fixtures, kept."""

    @functools.wraps(test)
    def limited(*args, **kwargs):
        with time_limit(WORLD_LIMIT_S):
            return test(*args, **kwargs)

    return limited

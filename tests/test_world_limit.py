"""tests/world_limit.py's time limit, without a JAX graph or a world."""

import inspect
import multiprocessing
import time

import pytest

import world_limit
from world_limit import time_limit, world_limited


def test_the_limit_ends_a_test_with_its_fixtures_kept(monkeypatch):
    def sleeper(monkeypatch, tmp_path):
        time.sleep(5)

    limited = world_limited(sleeper)
    assert inspect.signature(limited) == inspect.signature(sleeper)
    monkeypatch.setattr(world_limit, "WORLD_LIMIT_S", 1)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="limit of 1 s"):
        limited(None, None)
    assert time.monotonic() - t0 < 2


def test_the_limit_ends_the_child_started_under_it():
    child = multiprocessing.get_context("spawn").Process(target=time.sleep, args=(60,))
    with pytest.raises(TimeoutError, match="limit of 1 s"):
        with time_limit(1):
            child.start()
            child.join()
    assert not child.is_alive()
    assert child not in multiprocessing.active_children()

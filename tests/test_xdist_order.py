"""The root conftest.py's xdist scheduler, on made-up node ids and workers
that run nothing: its units, the order it hands them out in, and when
xdist gets it."""

import importlib.util
import pathlib
import types

from xdist.scheduler import LoadFileScheduling

ROOT = pathlib.Path(__file__).resolve().parent.parent

NODEIDS = [
    "tests/test_torch_one.py::test_a",
    "tests/test_sec2.py::test_completeness[p256r1]",
    "tests/test_sec2.py::test_homomorphism[p256r1]",
    "tests/test_sec2.py::test_completeness[p192k1]",
    "tests/test_sec2.py::test_homomorphism[p192k1]",
    "tests/test_field.py::test_a",
    "tests/test_field.py::test_b",
    "tests/test_msm.py::test_msm_sharded",
    "tests/test_msm.py::test_msm_local_p256r1",
    "tests/test_torch_two.py::test_a",
    "tests/test_torch_two.py::test_b",
    "tests/test_x25519.py::test_a",
]


def root_conftest():
    # By path: tests/conftest.py is imported under the same name.
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Config:
    class option:
        loadscopereorder = True

    def __init__(self, dist, workers):
        self.values = {"dist": dist, "tx": [f"{workers}*popen"]}

    def getvalue(self, name):
        return self.values[name]


class Log:
    def __call__(self, *args):
        pass

    def __getattr__(self, name):
        return self


class Worker:
    shutting_down = False

    def __init__(self, name):
        self.gateway = types.SimpleNamespace(id=name)
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent += [NODEIDS[i] for i in indices]

    def shutdown(self):
        self.shutting_down = True


def scheduler(conftest, workers):
    sched = conftest.pytest_xdist_make_scheduler(Config("loadfile", len(workers)), Log())
    for worker in workers:
        sched.add_node(worker)
        sched.add_node_collection(worker, NODEIDS)
    sched.schedule()
    return sched


def test_units_go_out_slowest_first_then_by_count():
    conftest = root_conftest()
    for unit in conftest.SLOWEST_FIRST:
        path, _, function = unit.partition("::")
        source = (ROOT / path).read_text()
        assert not function or f"\ndef {function}(" in source, unit
    units = {
        "tests/test_sec2.py::test_homomorphism": NODEIDS[2:5:2],
        "tests/test_msm.py::test_msm_local_p256r1": NODEIDS[8:9],
        "tests/test_sec2.py::test_completeness": NODEIDS[1:4:2],
        "tests/test_msm.py::test_msm_sharded": NODEIDS[7:8],
        "tests/test_field.py": NODEIDS[5:7],
        "tests/test_x25519.py": NODEIDS[11:],
        "tests/test_torch_two.py": NODEIDS[9:11],
        "tests/test_torch_one.py": NODEIDS[:1],
    }
    # As many workers as units: each takes one, in the order of the queue.
    workers = [Worker(f"gw{i}") for i in range(len(units))]
    scheduler(conftest, workers)
    assert [w.sent for w in workers] == list(units.values())
    # Two workers. A worker is sent its next unit when one test is left:
    # the first, with two, waits; the second, whose one test is a slow unit
    # it has not begun, gets the lightest slow unit, not the next slowest;
    # the first, one test later, gets the next slowest.
    first, second = Worker("gw0"), Worker("gw1")
    sched = scheduler(conftest, [first, second])
    assert first.sent == units["tests/test_sec2.py::test_homomorphism"]
    assert second.sent == units["tests/test_msm.py::test_msm_local_p256r1"] + units["tests/test_x25519.py"]
    sched.mark_test_complete(first, NODEIDS.index(first.sent[0]))
    assert first.sent[2:] == units["tests/test_sec2.py::test_completeness"]


def test_the_hook_takes_over_loadfile_only():
    hook = root_conftest().pytest_xdist_make_scheduler
    sched = hook(Config("loadfile", 6), Log())
    assert isinstance(sched, LoadFileScheduling)
    assert type(sched) is not LoadFileScheduling
    for dist in ("load", "loadscope", "loadgroup", "worksteal", "no"):
        assert hook(Config(dist, 6), Log()) is None, dist

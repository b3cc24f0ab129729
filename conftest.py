"""Tier-1's order: the one xdist scheduler of this repository.

Under ``--dist loadfile`` xdist sends each worker one unit of tests at a
time, a unit being a file, the files with the most tests first. The JAX
package's slow tests sit in few files: ``tests/test_msm.py`` has 4 tests
and takes about 1,120 s alone, ``tests/test_sec2.py`` 16 tests and about
1,170 s. In count order the first went out after every larger file, and
each ran in series on one worker, past tier-1's clock.

So here those two files go out one test function a unit (a function's
parametrized cases stay together and share their compiled graphs), every
other file stays one unit, and the JAX package's units go out first, in
the order of ``SLOWEST_FIRST``. The port's files follow in xdist's count
order and fill the workers at the end; if the clock cuts the run, what it
leaves unreported is a few files of few tests. The wall is then about the
suite's work over the workers.

This file imports neither jax nor torch: every pytest run under the repo
loads it, and xdist only when it is asked for a scheduler.
"""

SPLIT = ("tests/test_msm.py", "tests/test_sec2.py")

# The JAX package's units, longest first, with their seconds alone on an
# 8-core x86 host (one pytest process, the sum of --durations=0). The
# functions of the two SPLIT files were timed with those two files side by
# side, which costs each about a tenth more. The JAX package and its tests
# are frozen, so these go stale only as the host's speed moves them all.
SLOWEST_FIRST = (
    "tests/test_ed25519.py",  # 601
    "tests/test_ristretto.py",  # 587
    "tests/test_ed25519_batch.py",  # 544
    "tests/test_sec2.py::test_homomorphism",  # 504
    "tests/test_msm.py::test_msm_prefix_and_multi",  # 476
    "tests/test_msm.py::test_msm_local_p256r1",  # 367
    "tests/test_curve25519.py",  # 323
    "tests/test_sec2.py::test_completeness",  # 300
    "tests/test_msm.py::test_msm_local_duplicates_and_zeros",  # 279
    "tests/test_sec2.py::test_compress_roundtrip",  # 232
    "tests/test_msm.py::test_msm_sharded",  # 217
    "tests/test_field.py",  # 200
    "tests/test_kats.py",  # 162
    "tests/test_sec2.py::test_scalar_mul_kats",  # 150
    # 370 (its dryrun 257), out of place: the dryrun holds itself to 420 s
    # of wall clock, and beside five other JAX units it takes 1.6-1.7 times
    # its time alone. Here it goes out after the heavy units, so the dryrun
    # runs beside the port's files. The units after it are the lightest,
    # sent behind slow units of one test.
    "tests/test_parallel.py",
    "tests/test_x448.py",  # 87
    "tests/test_sec2.py::test_mul_base_comb_agreement",  # 57
    "tests/test_sec2.py::test_affine_api_p256r1",  # 37
    "tests/test_x25519.py",  # 33
    "tests/test_sha512.py",  # under 1
)


def unit(nodeid):
    """The unit of a test: its function in a ``SPLIT`` file, else its file."""
    path, _, name = nodeid.partition("::")
    if path in SPLIT:
        return f"{path}::{name.split('[', 1)[0]}"
    return path


def rank(unit_):
    """A unit's place in ``SLOWEST_FIRST``, or after it for the rest."""
    if unit_ in SLOWEST_FIRST:
        return SLOWEST_FIRST.index(unit_)
    return len(SLOWEST_FIRST)


def pytest_xdist_make_scheduler(config, log):
    """Under ``--dist loadfile``, the scheduler of ``unit`` and ``rank``;
    under any other mode, xdist's own choice."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SlowestFirstScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return unit(nodeid)

        def _reschedule(self, node):
            # A worker runs a test only once it holds the next one. xdist
            # sends the next unit when two tests are left; send it when one
            # is, so it waits behind one test.
            if self._pending_of(self.assigned_work[node]) < 2:
                super()._reschedule(node)

        def _assign_work_unit(self, node):
            # xdist queued the units in count order; a stable sort by rank
            # puts SLOWEST_FIRST ahead and keeps that order for the rest.
            order = sorted(self.workqueue, key=rank)
            slow = [u for u in order if u in SLOWEST_FIRST]
            held = self.assigned_work[node].items()
            if slow and any(u in SLOWEST_FIRST and not any(done.values()) for u, done in held):
                # The worker has not begun a slow unit of one test, so the
                # next unit waits behind all of it: send the lightest slow
                # unit, not the next slowest.
                order.insert(0, order.pop(order.index(slow[-1])))
            for unit_ in order:
                self.workqueue.move_to_end(unit_)
            super()._assign_work_unit(node)

    return SlowestFirstScheduling(config, log)

"""Test processes' CPU threads. pytest loads this file before
``tests/conftest.py``, so it runs before any test module imports torch."""

import os


def threads_per_worker(cpus, workers):
    """CPU threads for each test process: its share of the machine, at least 1.

    Left alone, every pytest-xdist worker starts torch with one OpenMP
    thread per CPU, so ``-n 6`` on 8 CPUs runs 48 threads. Each small torch
    op ends in an OpenMP barrier, and when one of its threads has lost its
    CPU the barrier waits a scheduler time slice: the port's CPU routes run
    thousands of small ops, and a bilateral WOW of a 256² frame that takes
    0.2 s alone took 75 s in the suite."""
    return max(1, cpus // workers)


# Only an xdist worker sizes its pool; the processes its tests spawn inherit
# the count. The controller leaves the environment alone, else its workers
# would inherit a count sized for one process. A value the caller set wins.
if "PYTEST_XDIST_WORKER" in os.environ:
    os.environ.setdefault("OMP_NUM_THREADS", str(threads_per_worker(
        len(os.sched_getaffinity(0)),
        int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))))

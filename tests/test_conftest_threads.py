"""The test processes' CPU thread pools (the repo root's ``conftest.py``):
each pytest-xdist worker runs torch on its share of the machine's CPUs, at
least one, unless the caller gave ``OMP_NUM_THREADS``; the controller
leaves the environment its workers inherit as the caller gave it."""

import os
import subprocess
import sys

import pytest
import torch

from conftest import threads_per_worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cpus, workers, threads", [
    (8, 6, 1),
    (8, 1, 8),
    (2, 6, 1),
    (8, 3, 2),
    (1, 1, 1),
])
def test_threads_per_worker(cpus, workers, threads):
    assert threads_per_worker(cpus, workers) == threads


def test_this_process_runs_its_share():
    """Under xdist torch's pool is the count the worker runs under (its
    share, or the caller's); outside xdist the helper gives every CPU."""
    cpus = len(os.sched_getaffinity(0))
    if "PYTEST_XDIST_WORKER" not in os.environ:
        assert threads_per_worker(cpus, 1) == cpus
        return
    assert torch.get_num_threads() == int(os.environ["OMP_NUM_THREADS"])


@pytest.mark.parametrize("worker, caller, variable, threads", [
    (False, None, "None", None),
    (True, None, "1", "1"),
    (True, "3", "3", "3"),
    (True, "4,2", "4,2", None),
])
def test_only_a_worker_sets_the_count(worker, caller, variable, threads):
    """Loading the conftest as a worker of ``-n <cpus>`` gives torch one
    thread, unless the caller gave a count, which stays as given (an
    OpenMP list too); loading it as the controller sets nothing for the
    workers to inherit."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "OMP_NUM_THREADS", "PYTEST_XDIST_WORKER", "PYTEST_XDIST_WORKER_COUNT")}
    if worker:
        env.update(PYTEST_XDIST_WORKER="gw0",
                   PYTEST_XDIST_WORKER_COUNT=str(len(os.sched_getaffinity(0))))
    if caller is not None:
        env["OMP_NUM_THREADS"] = caller
    out = subprocess.run(
        [sys.executable, "-c", "import os, conftest, torch; print("
         "os.environ.get('OMP_NUM_THREADS'), torch.get_num_threads())"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    got_variable, got_threads = out.stdout.split()[-2:]
    assert got_variable == variable, out.stdout
    if threads is not None:
        assert got_threads == threads, out.stdout

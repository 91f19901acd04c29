"""The chaos harness on the port's sharded service: ``chaos --kills 1`` of
a device-scale spec on the cluster-major engine over a 1-D mesh of two
gloo ranks on the CPU (`repro_torch.serve.chaos.run_supervised`).  The
SIGKILL of the job's process group leaves no rank of the killed job
alive, the restarted job resumes from rank 0's checkpoint, and the
recovered ``trace.jsonl`` equals an uninterrupted sharded run's byte for
byte.  And the job itself (`repro_torch.launch.distributed.run_job`,
ranks that only sleep): a rank that fails ends the job at once, and the
ranks die with a SIGKILLed supervisor.
"""
import os
import signal
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch.launch.distributed import run_job  # noqa: E402
from repro_torch.serve.__main__ import main  # noqa: E402
from repro_torch.serve.chaos import run_supervised  # noqa: E402
from repro_torch.serve.service import child_env, pid_alive  # noqa: E402
from test_torch_service_sharded import (SEGMENT_ROUNDS, loop,  # noqa: E402
                                        read, spec_dict, write_spec)


def test_chaos_kills_every_rank_and_recovers_the_trace(tmp_path):
    spec = write_spec(tmp_path / "spec.json", spec_dict((2,), "shard_map"))
    d = str(tmp_path / "chaos")
    summary = run_supervised(d, total_segments=3,
                             segment_rounds=SEGMENT_ROUNDS, kills=1, keep=0,
                             spec_file=spec, device="cpu", poll=0.01,
                             log=lambda *a, **k: None)
    assert summary["segments"] == 3 and summary["kills"] == 1
    kill = next(e for e in summary["events"] if e["event"] == "sigkill")
    assert len(kill["ranks"]) == 2 and kill["left_alive"] == []
    ref = str(tmp_path / "ref")
    assert main(["start", "--run-dir", ref, "--spec-file", spec,
                 "--foreground", "--max-segments", "3", *loop()]) == 0
    assert read(os.path.join(d, "trace.jsonl")) \
        == read(os.path.join(ref, "trace.jsonl"))


# a rank that prints its pid and sleeps; rank 1 exits with argv[1] if given
RANK = ("import os, sys, time\n"
        "from repro_torch.launch.distributed import die_with_job\n"
        "die_with_job()\n"
        "print(os.getpid(), flush=True)\n"
        "if os.environ['REPRO_DIST_PID'] == '1' and len(sys.argv) > 1:\n"
        "    sys.exit(int(sys.argv[1]))\n"
        "time.sleep(120)\n")


def test_a_failed_rank_ends_the_job():
    t0 = time.monotonic()
    assert run_job(["-c", RANK, "3"], 2, env=child_env()) == 3
    assert time.monotonic() - t0 < 60


def test_the_ranks_die_with_the_process_that_stands_for_them():
    sup = subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.launch.distributed import "
         f"run_job; run_job(['-c', {RANK!r}], 2)"], env=child_env(),
        stdout=subprocess.PIPE, text=True)
    ranks = [int(sup.stdout.readline()) for _ in range(2)]
    assert all(pid_alive(p) for p in ranks)
    os.kill(sup.pid, signal.SIGKILL)
    sup.wait()
    deadline = time.monotonic() + 30
    while any(pid_alive(p) for p in ranks) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(pid_alive(p) for p in ranks), ranks

"""The port's service mode (`repro_torch.serve`, `repro_torch.checkpoint`):
bit-exact checkpointed resume, streamed JSONL traces, the run-dir file
protocol, the service CLI and the chaos harness — and run dirs shared with
the JAX package.

The load-bearing guarantee is *segment parity*: a stopped-and-resumed run
(a fresh federation built from the spec, the checkpoint's leaves written
over it) continues the exact trace of the port's own uninterrupted run,
byte for byte in ``trace.jsonl`` and down to the f64 energy of the
manifest, also across a SIGKILL.  Run dirs have the JAX package's layout,
file names and formats: each package's read-only tools read the other's,
and the port refuses to resume a JAX package checkpoint, whose PRNG-key
leaf marks a random stream it cannot continue.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch import api as tapi  # noqa: E402
from repro_torch.api.records import (JsonlSink, read_jsonl_trace,  # noqa
                                     tail_jsonl)
from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    save_checkpoint, typed_key_leaves)
from repro_torch.checkpoint.ckpt import _leaves  # noqa: E402
from repro_torch.kernels import launches, reset_launches  # noqa: E402
from repro_torch.serve import (SegmentRunner, latest_resumable,  # noqa
                               prune_checkpoints, restore_resumable,
                               run_service, save_resumable,
                               truncate_jsonl_trace, verify_checkpoint)
from repro_torch.serve import runner as trunner  # noqa: E402
from repro_torch.serve.__main__ import main  # noqa: E402
from repro_torch.serve.chaos import run_supervised  # noqa: E402
from repro_torch.serve.dashboard import render  # noqa: E402
from repro_torch.serve.service import RunDir, service_status  # noqa: E402

try:            # the card's machine has no JAX: only the cuda test runs there
    import repro.serve as jserve
    from repro.api.records import read_jsonl_trace as jax_read_trace
    from repro.serve.__main__ import main as jax_main
    from repro.serve.dashboard import render as jax_render
    from repro.serve.service import service_status as jax_status
except ImportError:
    jserve = None

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

CONTROLLERS = [
    ("fixed", {"a": 3}),
    ("lyapunov", {"budget": 120.0, "horizon": 40}),
    ("dqn", {"episodes": 2, "horizon": 10}),
]
IDS = [k for k, _ in CONTROLLERS]


@pytest.fixture
def needs_jax():
    if jserve is None:
        pytest.skip("the JAX package is not installed")


def spec_dict(kind="fixed", params=None, seed=0, n_devices=8, clusters=2):
    return dict(fleet={"n_devices": n_devices},
                clustering={"n_clusters": clusters},
                controller={"kind": kind,
                            "params": dict(params or {"a": 2})},
                task={"kind": "mlp", "params": {"n_samples": 512, "dim": 16,
                                                "hidden": 8}},
                execution="scanned", rounds=3, sim_seconds=1e9,
                local_batch=16, seed=seed)


def fed(d):
    return tapi.Federation.from_dict(d, device="cpu")


def write_spec(path, d):
    path.write_text(json.dumps(d))
    return str(path)


def start(run_dir, spec_file, segments, *extra, cli=main):
    argv = ["start", "--run-dir", run_dir, "--spec-file", spec_file,
            "--segment-rounds", "3", "--max-segments", str(segments),
            "--keep", "0", "--foreground", *extra]
    return cli(argv + (["--device", "cpu"] if cli is main else []))


def read(path):
    with open(path, "rb") as f:
        return f.read()


# one run dir of each package on the same tiny spec (the JAX package
# compiles its segment once for the file)
@pytest.fixture(scope="module")
def shared_spec(tmp_path_factory):
    return write_spec(tmp_path_factory.mktemp("spec") / "spec.json",
                      spec_dict(seed=11))


@pytest.fixture(scope="module")
def port_run_dir(tmp_path_factory, shared_spec):
    d = str(tmp_path_factory.mktemp("port") / "run")
    assert start(d, shared_spec, 2) == 0
    return d


@pytest.fixture(scope="module")
def jax_run_dir(tmp_path_factory, shared_spec):
    if jserve is None:
        pytest.skip("the JAX package is not installed")
    d = str(tmp_path_factory.mktemp("jax") / "run")
    assert start(d, shared_spec, 2, cli=jax_main) == 0
    return d


# --------------------------------------------------------------------- #
# resume bit-parity (the tentpole invariant)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,params", CONTROLLERS, ids=IDS)
def test_resume_bit_parity(tmp_path, kind, params):
    d = spec_dict(kind, params, seed=1)
    K = 4
    want = fed(d).engine.run_scanned(2 * K, eval_final=False).records

    ckpt = str(tmp_path / "ckpts")
    fed1 = fed(d)
    first = fed1.engine.run_scanned(K, eval_final=False).records
    save_resumable(fed1, ckpt, segment=1)

    # a fresh federation stands in for a fresh process: every leaf is
    # rebuilt from the spec, then overwritten from the checkpoint
    fed2 = fed(d)
    manifest = restore_resumable(fed2, ckpt)
    assert manifest["rounds"] == K
    assert manifest["energy"] == fed1.engine.energy_used   # exact f64
    second = fed2.engine.run_scanned(K, eval_final=False).records

    got = first + second
    assert len(got) == len(want) == 2 * K
    for a, b in zip(want, got):
        assert a == b          # dataclass eq: every float compares exact


@pytest.mark.parametrize("kind,params", CONTROLLERS, ids=IDS)
def test_cli_resume_trace_byte_equal(tmp_path, kind, params):
    """``start`` for two segments then ``resume`` for one gives the
    trace.jsonl and manifest energy of an uninterrupted three-segment
    run."""
    spec_file = write_spec(tmp_path / "spec.json",
                           spec_dict(kind, params, seed=2))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert start(a, spec_file, 2) == 0
    assert main(["resume", "--run-dir", a, "--segment-rounds", "3",
                 "--max-segments", "1", "--keep", "0", "--foreground",
                 "--device", "cpu"]) == 0
    assert start(b, spec_file, 3) == 0
    assert read(os.path.join(a, "trace.jsonl")) \
        == read(os.path.join(b, "trace.jsonl"))
    ma, mb = (latest_resumable(os.path.join(x, "checkpoints"))[1]
              for x in (a, b))
    assert ma["rounds"] == mb["rounds"] == 9
    assert ma["energy"] == mb["energy"]
    assert read_jsonl_trace(os.path.join(a, "trace.jsonl")).n_records == 12


@pytest.mark.parametrize("kind,params", [CONTROLLERS[0], CONTROLLERS[2]],
                         ids=["fixed", "dqn"])
def test_every_resumable_leaf_roundtrips_bitwise(tmp_path, kind, params):
    """Every resumable leaf (the fleet, the event times, the DQN's
    deployed net) survives the npz round trip with dtype and bits
    intact."""
    f = fed(spec_dict(kind, params, seed=3))
    f.engine.run_scanned(3, eval_final=False)
    save_resumable(f, str(tmp_path), segment=1)
    like = trunner._resumable_tree(f)
    path, _ = latest_resumable(str(tmp_path))
    got = load_checkpoint(path, like)
    want_leaves, got_leaves = dict(_leaves(like)), dict(_leaves(got))
    assert list(got_leaves) == list(want_leaves)
    assert len(want_leaves) == 23 + (6 if kind == "dqn" else 0)
    for k, a in want_leaves.items():
        b = got_leaves[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k
    assert isinstance(got["fleet"], tapi.FleetTree)
    state = tapi.fleet_state_from_numpy(got["fleet"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        state.tensors().values(), f.engine.state.tensors().values()))


def test_bf16_and_structured_leaves_roundtrip(tmp_path):
    tree = {"b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
            "a": [torch.arange(3), (np.float32(2.5) * np.ones(2),)],
            "t": tapi.FleetTree(*([torch.ones(2)] * 8))}
    path = save_checkpoint(str(tmp_path), 7, tree)
    assert path.endswith("ckpt_00000007.npz")
    assert not os.path.exists(path + ".tmp")
    with np.load(path) as z:
        assert "__bf16__:b" in z.files and "a/1/0" in z.files
        assert "t/.cluster_params" in z.files
    got = load_checkpoint(path, tree)
    assert got["b"].dtype == torch.bfloat16
    assert torch.equal(got["b"], tree["b"])
    assert torch.equal(got["a"][0], tree["a"][0])
    assert got["a"][1][0].dtype == np.float64
    assert isinstance(got["t"], tapi.FleetTree)
    assert typed_key_leaves(path) == []


def test_runner_streams_identical_trace_across_resume(tmp_path):
    """trace.jsonl of stop-and-resume equals an uninterrupted segmented
    run's, byte for byte (per-segment eval records included)."""
    d = spec_dict(seed=3)

    def streamed(name, ckpt, federations):
        path = str(tmp_path / name)
        for i, f in enumerate(federations):
            f.engine.set_trace_sink(JsonlSink(path), retain=False)
            runner = SegmentRunner(f, ckpt, segment_rounds=3)
            if i:
                runner.maybe_resume()
            trace = runner.run_segment()
            assert trace.records == [] and trace.n_records == 4
            f.engine.trace_sink.close()
        return path

    one = fed(d)
    a = streamed("a.jsonl", str(tmp_path / "ca"), [one, one])
    b = streamed("b.jsonl", str(tmp_path / "cb"), [fed(d), fed(d)])
    assert read(a) == read(b)
    trace = read_jsonl_trace(b)
    assert trace.n_records == 8            # 2 * (3 rounds + 1 eval)
    assert trace.records[-1].acc is not None


def test_retention_prunes_old_checkpoints(tmp_path):
    f = fed(spec_dict("fixed", {"a": 1}, seed=4))
    runner = SegmentRunner(f, str(tmp_path), segment_rounds=2, keep=2)
    for _ in range(4):
        runner.run_segment()
    files = sorted(x for x in os.listdir(tmp_path) if x.endswith(".npz"))
    assert files == ["ckpt_00000006.npz", "ckpt_00000008.npz"]
    assert latest_resumable(str(tmp_path))[1]["rounds"] == 8


def test_incomplete_checkpoint_is_skipped(tmp_path):
    """An npz without its manifest (crash between the two writes) and a
    torn ``.tmp`` (crash mid-write) must not be chosen for resume."""
    f = fed(spec_dict("fixed", {"a": 1}, seed=5))
    runner = SegmentRunner(f, str(tmp_path), segment_rounds=2)
    runner.run_segment()
    complete, _ = latest_resumable(str(tmp_path))
    with open(tmp_path / "ckpt_00000099.npz", "wb") as fh:
        fh.write(b"not a real checkpoint")    # no .json sidecar
    with open(tmp_path / "ckpt_00000098.npz.tmp", "wb") as fh:
        fh.write(b"torn")
    assert latest_resumable(str(tmp_path))[0] == complete


def test_corrupt_checkpoint_falls_back_to_verified(tmp_path):
    d = spec_dict("fixed", {"a": 1}, seed=6)
    runner = SegmentRunner(fed(d), str(tmp_path), segment_rounds=2,
                           keep=None)
    runner.run_segment()
    good, good_manifest = latest_resumable(str(tmp_path))
    runner.run_segment()
    newest, _ = latest_resumable(str(tmp_path))
    assert newest != good and verify_checkpoint(newest)

    with open(newest, "r+b") as fh:
        fh.truncate(os.path.getsize(newest) // 2)
    assert not verify_checkpoint(newest)
    path, manifest = latest_resumable(str(tmp_path))
    assert path == good and manifest == good_manifest
    assert restore_resumable(fed(d), str(tmp_path))["rounds"] == 2

    prune_checkpoints(str(tmp_path), keep=2)
    assert not os.path.exists(newest)
    assert os.path.exists(good)


def test_legacy_manifest_without_digest_still_verifies(tmp_path):
    f = fed(spec_dict("fixed", {"a": 1}, seed=7))
    f.engine.run_scanned(2, eval_final=False)
    npz = save_resumable(f, str(tmp_path), segment=1)
    mpath = npz[:-len(".npz")] + ".json"
    with open(mpath) as fh:
        manifest = json.load(fh)
    assert sorted(manifest) == ["bytes", "crc32", "energy", "rounds",
                                "segment", "step"]
    for k in ("crc32", "bytes"):
        manifest.pop(k)
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)
    assert verify_checkpoint(npz)
    assert latest_resumable(str(tmp_path))[0] == npz


def test_stale_pidfile_is_cleaned(tmp_path):
    rd = RunDir(str(tmp_path)).ensure()
    with open(rd.path("serve.pid"), "w") as fh:
        fh.write("999999999")            # beyond pid_max: never alive
    assert rd.running_pid() is None
    assert not os.path.exists(rd.path("serve.pid"))


def test_rundir_pid_and_requests(tmp_path):
    rd = RunDir(str(tmp_path)).ensure()
    assert rd.running_pid() is None
    rd.write_pid()
    assert rd.running_pid() == os.getpid()
    rd.clear_pid()
    assert rd.running_pid() is None
    assert not rd.take_request("stop.req")
    rd.request("stop.req")
    assert rd.take_request("stop.req")
    assert not rd.take_request("stop.req")


# --------------------------------------------------------------------- #
# JSONL plumbing
# --------------------------------------------------------------------- #
def test_truncate_jsonl_trace(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as fh:
        for r in range(1, 7):
            fh.write(json.dumps({"round": r, "loss": r * 0.5}) + "\n")
        fh.write('{"round": 7, "los')           # torn tail from a crash
    assert truncate_jsonl_trace(path, 4) == 3   # rounds 5, 6 + torn line
    with open(path) as fh:
        kept = [json.loads(line) for line in fh]
    assert [r["round"] for r in kept] == [1, 2, 3, 4]
    assert truncate_jsonl_trace(str(tmp_path / "missing.jsonl"), 4) == 0


def test_tail_jsonl_reads_only_the_tail(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as fh:
        for r in range(200):
            fh.write(json.dumps({"round": r}) + "\n")
        fh.write('{"round": 200, "lo')          # torn final line
    assert [d["round"] for d in tail_jsonl(path, n=5, block=64)] \
        == [195, 196, 197, 198, 199]
    assert tail_jsonl(str(tmp_path / "missing.jsonl")) == []
    open(tmp_path / "empty.jsonl", "w").close()
    assert tail_jsonl(str(tmp_path / "empty.jsonl")) == []


# --------------------------------------------------------------------- #
# the service CLI (in-process, --foreground --device cpu)
# --------------------------------------------------------------------- #
def test_service_cli_lifecycle(tmp_path, capsys):
    spec_file = write_spec(tmp_path / "spec.json", spec_dict(seed=11))
    run_dir = str(tmp_path / "run")
    assert start(run_dir, spec_file, 2) == 0
    st = service_status(run_dir)
    assert not st["alive"]
    assert st["state"]["status"] == "stopped"
    assert st["state"]["rounds"] == 6
    assert st["latest_checkpoint"].endswith("ckpt_00000006.npz")

    capsys.readouterr()
    assert main(["checkpoint", "--run-dir", run_dir]) == 0
    assert capsys.readouterr().out.strip() == st["latest_checkpoint"]

    # `start` refuses a run dir that already has checkpoints...
    assert start(run_dir, spec_file, 1) == 1
    # ...and `resume` continues it (one more segment)
    assert main(["resume", "--run-dir", run_dir, "--segment-rounds", "3",
                 "--max-segments", "1", "--foreground",
                 "--device", "cpu"]) == 0
    st = service_status(run_dir)
    assert st["state"]["rounds"] == 9
    assert st["metrics"]["service_resumes_total"] == 1
    trace = read_jsonl_trace(os.path.join(run_dir, "trace.jsonl"))
    assert trace.n_records == 12
    assert [r.round for r in trace.records if r.acc is None] \
        == list(range(1, 10))

    assert main(["stop", "--run-dir", run_dir]) == 0
    assert main(["resume", "--run-dir", str(tmp_path / "empty"),
                 "--foreground", "--device", "cpu"]) == 1


def test_cli_without_a_card_exits_with_resolve_devices_error(tmp_path,
                                                             capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    spec_file = write_spec(tmp_path / "spec.json", spec_dict())
    run_dir = str(tmp_path / "run")
    for argv in (["start", "--run-dir", run_dir, "--spec-file", spec_file,
                  "--foreground"],
                 ["start", "--run-dir", run_dir, "--spec-file", spec_file],
                 ["resume", "--run-dir", run_dir, "--foreground"],
                 ["chaos", "--run-dir", run_dir, "--spec-file", spec_file]):
        capsys.readouterr()
        assert main(argv) == 1
        assert "device='cpu'" in capsys.readouterr().err
    assert not os.path.exists(run_dir)


def test_unported_specs_and_pool_exit_2(tmp_path, capsys):
    assert main(["start", "--run-dir", str(tmp_path / "lm"), "--scenario",
                 "lm-modeA", "--device", "cpu", "--foreground"]) == 2
    assert "item 10" in capsys.readouterr().err
    assert main(["chaos", "--run-dir", str(tmp_path / "lm2"), "--scenario",
                 "lm-modeA", "--device", "cpu"]) == 2
    assert "item 10" in capsys.readouterr().err
    # the pool runs since populations were ported; what it cannot run
    # yet exits 2 naming its item: an LM base spec.  A sharded population
    # runs, as a job of ranks
    assert main(["pool", "start", "--run-dir", str(tmp_path / "pool"),
                 "--scenario", "lm-modeA", "--device", "cpu",
                 "--foreground"]) == 2
    assert "item 10" in capsys.readouterr().err
    pspec = {"base": spec_dict(), "replicates": 2,
             "sharding": {"mesh": [2]}}
    assert main(["pool", "start", "--run-dir", str(tmp_path / "pool2"),
                 "--spec-file", write_spec(tmp_path / "pool.json", pspec),
                 "--device", "cpu", "--foreground", "--segment-rounds", "2",
                 "--max-segments", "1"]) == 0
    assert "not ported" not in capsys.readouterr().err


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.serve, repro_torch.serve.__main__, "
            "repro_torch.serve.dashboard, repro_torch.obs, "
            "repro_torch.checkpoint;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro'];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --------------------------------------------------------------------- #
# chaos: SIGKILL mid-segment, supervised recovery in subprocesses
# --------------------------------------------------------------------- #
def test_chaos_sigkill_recovery_trace_parity(tmp_path):
    """SIGKILL the service after a checkpoint lands (next segment in
    flight), let the supervisor restart it, and byte-compare trace.jsonl
    against an uninterrupted run of the same spec, under the DQN (each
    child pretrains its own, then adopts the checkpointed net)."""
    kind, params = CONTROLLERS[2]
    spec_file = write_spec(tmp_path / "spec.json",
                           spec_dict(kind, params, seed=13))
    ref = str(tmp_path / "ref")
    assert start(ref, spec_file, 4) == 0

    # a CPU segment of this spec takes a few ms: poll often enough that
    # the kill lands while segments are still owed
    chaos = str(tmp_path / "chaos")
    summary = run_supervised(
        chaos, total_segments=4, segment_rounds=3, kills=1, keep=0,
        spec_file=spec_file, device="cpu", poll=0.002,
        log=lambda *a, **k: None)
    assert summary["segments"] == 4
    assert summary["kills"] == 1
    assert summary["restarts"] >= 1
    assert len(summary["startups"]) == summary["restarts"] + 1
    assert all(s["pidfile_s"] is not None for s in summary["startups"])

    assert read(os.path.join(ref, "trace.jsonl")) \
        == read(os.path.join(chaos, "trace.jsonl"))
    st = service_status(chaos)
    assert not st["alive"]
    assert st["checkpoint_manifest"]["rounds"] == 12
    assert st["metrics"]["chaos_sigkills_total"] == 1
    assert st["metrics"]["chaos_restarts_total"] == summary["restarts"]


# --------------------------------------------------------------------- #
# run dirs shared with the JAX package
# --------------------------------------------------------------------- #
def test_each_package_reads_the_others_run_dir(needs_jax, port_run_dir,
                                               jax_run_dir):
    """The same files give the same status dict and the same dashboard
    frame through either package; traces and checkpoints read and verify
    across packages."""
    for d in (port_run_dir, jax_run_dir):
        st, jst = service_status(d), jax_status(d)
        assert st == jst
        assert render(st) == jax_render(jst)
        assert st["state"]["rounds"] == 6
        assert st["metrics"]["fl_rounds_total"] == 6
        assert st["metrics"]["fl_checkpoints_total"] == 2
        assert st["metrics"]["service_segments_total"] == 2
        assert st["latest_checkpoint"].endswith("ckpt_00000006.npz")
        trace = os.path.join(d, "trace.jsonl")
        assert read_jsonl_trace(trace).records \
            == [tapi.RoundRecord(**vars(r))
                for r in jax_read_trace(trace).records]
        path = st["latest_checkpoint"]
        assert verify_checkpoint(path) and jserve.verify_checkpoint(path)
        assert latest_resumable(os.path.join(d, "checkpoints")) \
            == jserve.latest_resumable(os.path.join(d, "checkpoints"))
    # the two manifests carry the same fields, of the same types
    mp = service_status(port_run_dir)["checkpoint_manifest"]
    mj = service_status(jax_run_dir)["checkpoint_manifest"]
    assert sorted(mp) == sorted(mj)
    assert {k: type(v) for k, v in mp.items()} \
        == {k: type(v) for k, v in mj.items()}
    # metrics.jsonl holds the same record kinds (the JAX package's also
    # its compile event; the port loads no kernel library on the CPU)
    kinds = lambda d: {r.get("schema") for r in tail_jsonl(
        os.path.join(d, "metrics.jsonl"), n=64)}
    assert kinds(port_run_dir) | {"event/1"} == kinds(jax_run_dir)


def test_port_reads_a_jax_checkpoint_but_refuses_to_resume_it(
        needs_jax, jax_run_dir, tmp_path):
    path, manifest = latest_resumable(os.path.join(jax_run_dir,
                                                   "checkpoints"))
    assert typed_key_leaves(path) == ["fleet/.key"]
    with open(os.path.join(jax_run_dir, "spec.json")) as fh:
        d = json.load(fh)
    f = fed(d)
    like = trunner._resumable_tree(f)
    tree = load_checkpoint(path, like)
    with np.load(path) as z:
        jax_leaves = {k: z[k] for k in z.files}
    leaves, like_leaves = dict(_leaves(tree)), dict(_leaves(like))
    assert set(jax_leaves) - set(leaves) == {"__key__:threefry2x32:"
                                             "fleet/.key"}
    for k, v in leaves.items():
        assert v.dtype == like_leaves[k].dtype      # the port's own dtypes
        np.testing.assert_array_equal(v.numpy(), jax_leaves[k])
    state = tapi.fleet_state_from_numpy(tree["fleet"], "cpu")
    np.testing.assert_array_equal(state.cluster_flat.numpy(), np.concatenate(
        [jax_leaves[f"fleet/.cluster_params/{k}"].reshape(2, -1)
         for k in ("b1", "b2", "w1", "w2")], axis=1))
    assert int(state.round) == manifest["rounds"] == 6

    with pytest.raises(ValueError, match="JAX package checkpoint"):
        restore_resumable(f, os.path.join(jax_run_dir, "checkpoints"))
    copy = str(tmp_path / "jax_copy")
    shutil.copytree(jax_run_dir, copy)
    with pytest.raises(ValueError, match="cannot resume"):
        main(["resume", "--run-dir", copy, "--foreground",
              "--device", "cpu"])


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_segment_parity_on_the_card(tmp_path):
    """A service on the card, stopped after two segments and resumed for
    one, writes the trace.jsonl and the f64 manifest energy of an
    uninterrupted three-segment run; every round launches the fused
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    d = spec_dict("lyapunov", {"budget": 400.0, "horizon": 30}, seed=3,
                  n_devices=64, clusters=4)
    dirs = {}
    for name in ("a", "b"):
        rd = RunDir(str(tmp_path / name)).ensure()
        rd.write_spec(tapi.FederationSpec.from_dict(d))
        dirs[name] = rd.root
    reset_launches()
    run_service(dirs["a"], segment_rounds=4, max_segments=2, keep=None,
                device="cuda", log=lambda *a: None)
    assert launches["trust_aggregate_global"] == 8
    run_service(dirs["a"], segment_rounds=4, max_segments=1, keep=None,
                resume=True, device="cuda", log=lambda *a: None)
    assert launches["trust_aggregate_global"] == 12
    run_service(dirs["b"], segment_rounds=4, max_segments=3, keep=None,
                device="cuda", log=lambda *a: None)
    assert launches["trust_aggregate_global"] == 24
    assert read(os.path.join(dirs["a"], "trace.jsonl")) \
        == read(os.path.join(dirs["b"], "trace.jsonl"))
    ma, mb = (latest_resumable(os.path.join(x, "checkpoints"))[1]
              for x in dirs.values())
    assert ma["energy"] == mb["energy"] and ma["rounds"] == 12

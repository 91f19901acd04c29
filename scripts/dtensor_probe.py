"""Which DTensor collectives and ops work between ranks of one host.

    python3 scripts/dtensor_probe.py [--device cuda|cpu] [--only STAGE-G ...]

Starts jobs of 2 and 4 ranks (`repro_torch.launch.distributed.spawn_local`;
on one card the backend rule picks gloo, with a card a rank NCCL), one job
a stage, so that a rank that dies in one (a segfault in a collective)
leaves the others' results:

  * ``c10d``: the process group's own ``all_reduce``, ``broadcast``,
    ``all_gather_into_tensor``, ``all_gather`` and
    ``reduce_scatter_tensor`` on tensors of ``--device``;
  * ``funcol_all_gather`` / ``_all_reduce`` / ``_reduce_scatter``: each
    functional collective DTensor's redistributions call, alone;
  * ``mesh``: the meshes (2,), (4,) and (2, 2) of
    `launch.distributed.device_mesh` and each dim's backend;
  * ``dtensor``: on those meshes, the three redistributions the
    partitioner-inferred placement needs (``Shard(0) -> Replicate()``,
    ``Partial() -> Replicate()``, ``Partial() -> Shard(0)``) over every
    mesh dim, and the ops of a round on a ``Shard(0)`` table: a gather by
    a replicated index, ``index_select`` of a 0-d index, ``index_copy``,
    an in-place ``index_put_``, a sum, ``argmin``, plain tensors under
    ``implicit_replication``, a custom operator with a
    ``register_sharding`` rule, ``local_map`` and ``distribute_tensor``.

Each case prints ``ok`` or its error (at once, to standard error); one
JSON line per rank (``PROBE{...}``) and a summary on the parent's last
line.  Nothing falls back: the probe reports what failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

MESHES = {2: [(2,)], 4: [(4,), (2, 2)]}
AXES = {1: ("fleet",), 2: ("cluster", "fleet")}


def _case(out: dict, name: str, fn) -> None:
    print(f"case {name}", file=sys.stderr, flush=True)
    try:
        fn()
        out[name] = "ok"
    except Exception as e:       # noqa: BLE001  (the probe reports it)
        out[name] = f"{type(e).__name__}: {e}"[:400]
        traceback.print_exc()
    # at once, so that a later segfault keeps it
    print(f"result {name}: {out[name]}", file=sys.stderr, flush=True)


def raw_collectives(device: str, which: str) -> dict:
    """The process group's own collectives on tensors of ``device``
    (``which`` "c10d"), or one of the functional collectives DTensor's
    redistributions call (``which`` its name), alone."""
    import torch
    import torch.distributed as dist
    G, r = dist.get_world_size(), dist.get_rank()
    dev = torch.device(device)
    out = {}

    def all_reduce():
        t = torch.full((4,), float(r + 1), device=dev)
        dist.all_reduce(t)
        assert t.tolist() == [G * (G + 1) / 2] * 4

    def broadcast():
        t = torch.full((4,), float(r), device=dev)
        dist.broadcast(t, src=0)
        assert t.tolist() == [0.0] * 4

    def all_gather():
        t = torch.full((2,), float(r), device=dev)
        o = torch.empty((2 * G,), device=dev)
        dist.all_gather_into_tensor(o, t)
        assert o.tolist() == [float(i) for i in range(G) for _ in (0, 1)]

    def all_gather_list():
        t = torch.full((2,), float(r), device=dev)
        o = [torch.empty((2,), device=dev) for _ in range(G)]
        dist.all_gather(o, t)
        assert [x[0].item() for x in o] == [float(i) for i in range(G)]

    def reduce_scatter():
        t = torch.ones((2 * G,), device=dev)
        o = torch.empty((2,), device=dev)
        dist.reduce_scatter_tensor(o, t)
        assert o.tolist() == [float(G)] * 2

    import torch.distributed._functional_collectives as fc
    world = dist.group.WORLD

    def fc_all_gather():
        t = torch.full((2,), float(r), device=dev)
        g = fc.all_gather_tensor(t, 0, world)
        assert g.tolist() == [float(i) for i in range(G) for _ in (0, 1)]

    def fc_all_reduce():
        t = torch.full((2,), float(r), device=dev)
        s = fc.all_reduce(t, "sum", world)
        assert s.tolist() == [G * (G - 1) / 2] * 2

    def fc_reduce_scatter():
        t = torch.ones((2 * G,), device=dev)
        s = fc.reduce_scatter_tensor(t, "sum", 0, world)
        assert s.tolist() == [float(G)] * 2

    cases = {"c10d": (("all_reduce", all_reduce), ("broadcast", broadcast),
                      ("all_gather_into_tensor", all_gather),
                      ("all_gather", all_gather_list),
                      ("reduce_scatter_tensor", reduce_scatter)),
             "funcol_all_gather": (("funcol_all_gather", fc_all_gather),),
             "funcol_all_reduce": (("funcol_all_reduce", fc_all_reduce),),
             "funcol_reduce_scatter": (("funcol_reduce_scatter",
                                        fc_reduce_scatter),)}
    for name, fn in cases[which]:
        _case(out, name, fn)
    return out


def worker(device: str, stage: str) -> None:
    import faulthandler
    faulthandler.enable()
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from torch.distributed.tensor.experimental import (implicit_replication,
                                                       local_map,
                                                       register_sharding)

    from repro_torch.launch.distributed import (device_mesh,
                                                initialize_from_env)
    rank = initialize_from_env(device)
    G = dist.get_world_size()
    dev = torch.device(device)
    out = {"rank": rank, "world": G, "torch": torch.__version__,
           "cuda": torch.version.cuda, "backend": dist.get_backend(),
           "stage": stage, "cases": {}}
    if stage in ("c10d", "funcol_all_gather", "funcol_all_reduce",
                 "funcol_reduce_scatter"):
        out["cases"]["world"] = raw_collectives(device, stage)
        print("PROBE" + json.dumps(out), flush=True)
        dist.destroy_process_group()
        return

    def _rowsum(x, w):
        return (x * w[:, None]).sum(0)
    rowsum = torch.library.custom_op(
        "probe::rowsum", _rowsum, mutates_args=(),
        schema="(Tensor x, Tensor w) -> Tensor")

    @rowsum.register_fake
    def _(x, w):
        return x.new_empty(x.shape[1:])

    @register_sharding(torch.ops.probe.rowsum.default)
    def _(x, w):
        return [([Replicate()], [Replicate(), Replicate()]),
                ([Shard(0)], [Shard(1), Replicate()])]

    def put_on(full, mesh, placements):
        # this rank's chunk of ``full``, without a collective
        loc = full
        for d, p in enumerate(placements):
            if isinstance(p, Shard):
                loc = loc.chunk(mesh.size(d), p.dim)[mesh.get_local_rank(d)]
        return DTensor.from_local(loc.contiguous(), mesh, list(placements),
                                  run_check=False)

    for shape in MESHES[G]:
        tag = "x".join(map(str, shape))
        cases = out["cases"].setdefault(tag, {})
        print(f"mesh {tag}", file=sys.stderr, flush=True)
        mesh = device_mesh(shape, AXES[len(shape)], dev)
        cases["groups"] = [dist.get_backend(mesh.get_group(i))
                           for i in range(len(shape))]
        if stage == "mesh":
            continue
        n = 8 * G
        full = torch.arange(n * 3, dtype=torch.float32,
                            device=dev).reshape(n, 3)
        for d in range(len(shape)):
            pl = [Replicate()] * len(shape)

            def at(p, d=d, pl=pl):
                q = list(pl)
                q[d] = p
                return q

            def gather():
                x = put_on(full, mesh, at(Shard(0)))
                y = x.redistribute(mesh, at(Replicate())).to_local()
                assert torch.equal(y, full), "all-gather values"

            def reduce():
                loc = full * (1 + dist.get_rank())
                x = DTensor.from_local(loc, mesh, at(Partial()),
                                       run_check=False)
                y = x.redistribute(mesh, at(Replicate())).to_local()
                k = shape[d]
                me = mesh.get_local_rank(d)
                grp = [r for r in range(G)
                       if _coord(r, shape)[:d] + _coord(r, shape)[d + 1:]
                       == _coord(dist.get_rank(), shape)[:d]
                       + _coord(dist.get_rank(), shape)[d + 1:]]
                want = full * sum(1 + r for r in grp)
                assert len(grp) == k and me >= 0
                assert torch.allclose(y, want), "all-reduce values"

            def scatter():
                loc = full * 1.0
                x = DTensor.from_local(loc, mesh, at(Partial()),
                                       run_check=False)
                y = x.redistribute(mesh, at(Shard(0))).to_local()
                k, me = shape[d], mesh.get_local_rank(d)
                want = (full * k).chunk(k)[me]
                assert torch.equal(y, want), "reduce-scatter values"

            _case(cases, f"dim{d}_shard_to_replicate", gather)
            _case(cases, f"dim{d}_partial_to_replicate", reduce)
            _case(cases, f"dim{d}_partial_to_shard", scatter)

        fleet = [Replicate()] * (len(shape) - 1) + [Shard(0)]
        rep = [Replicate()] * len(shape)

        def table():
            return put_on(full, mesh, fleet)

        def gather_idx():
            idx = put_on(torch.tensor([n - 1, 0, 3], device=dev), mesh,
                         rep)
            got = table()[idx].full_tensor()
            assert torch.equal(got, full[[n - 1, 0, 3]])

        def select0d():
            c = put_on(torch.tensor(5, device=dev), mesh, rep)
            got = table().index_select(0, c.reshape(1))[0].full_tensor()
            assert torch.equal(got, full[5])

        def index_copy():
            c = put_on(torch.tensor([2], device=dev), mesh, rep)
            v = put_on(torch.ones((1, 3), device=dev), mesh, rep)
            got = table().index_copy(0, c, v).full_tensor()
            want = full.clone()
            want[2] = 1.0
            assert torch.equal(got, want)

        def index_put():
            buf = table().redistribute(mesh, rep)
            idx = put_on(torch.tensor([1, 6], device=dev), mesh, rep)
            buf[idx] = put_on(torch.zeros((2, 3), device=dev), mesh, rep)
            want = full.clone()
            want[[1, 6]] = 0.0
            assert torch.equal(buf.full_tensor(), want)

        def reductions():
            t = table()
            assert torch.allclose(t.sum().full_tensor(), full.sum())
            assert int(t[:, 0].argmin().full_tensor()) == 0

        def implicit():
            with implicit_replication():
                got = (table() + torch.ones(3, device=dev)).full_tensor()
            assert torch.equal(got, full + 1)

        def custom():
            w = torch.linspace(0, 1, n, device=dev)
            x = put_on(full, mesh, rep)
            wd = put_on(w, mesh, rep)
            got = rowsum(x, wd)
            assert isinstance(got, DTensor)
            assert torch.allclose(got.full_tensor(), (full * w[:, None])
                                  .sum(0))

        def localmap():
            f = local_map(lambda a: a * 2, out_placements=(tuple(fleet),),
                          in_placements=(tuple(fleet),))
            assert torch.equal(f(table()).full_tensor(), full * 2)

        def scatter_from_rank0():
            got = distribute_tensor(full, mesh, fleet).full_tensor()
            assert torch.equal(got, full)

        for name, fn in (("gather_by_index", gather_idx),
                         ("index_select_0d", select0d),
                         ("index_copy", index_copy),
                         ("index_put", index_put),
                         ("sum_argmin", reductions),
                         ("implicit_replication", implicit),
                         ("register_sharding_op", custom),
                         ("local_map", localmap),
                         ("distribute_tensor", scatter_from_rank0)):
            _case(cases, name, fn)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    print("PROBE" + json.dumps(out), flush=True)
    dist.destroy_process_group()


def _coord(r: int, shape) -> tuple:
    out = []
    for k in reversed(shape):
        out.append(r % k)
        r //= k
    return tuple(reversed(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", nargs="+", metavar="STAGE-G",
                    help="run only these jobs, e.g. c10d-4 dtensor-4")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a job may take")
    ap.add_argument("--worker", metavar="STAGE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.device, args.worker)
        return 0
    from repro_torch.launch.distributed import spawn_local
    summary, ok = {}, True
    # one job a stage, so that a rank that dies in one (a segfault in a
    # collective) leaves the others' results
    stages = (("c10d", 2), ("c10d", 4), ("funcol_all_gather", 2),
              ("funcol_all_reduce", 2), ("funcol_reduce_scatter", 2),
              ("mesh", 2), ("mesh", 4), ("dtensor", 2), ("dtensor", 4))
    if args.only:
        stages = [s for s in stages if f"{s[0]}-{s[1]}" in args.only]
    for stage, G in stages:
        try:
            res = spawn_local([os.path.abspath(__file__), "--worker", stage,
                               "--device", args.device], n_procs=G,
                              timeout=args.timeout)
        except subprocess.TimeoutExpired as e:
            print(f"{stage} G={G}: no end within {args.timeout} s; where "
                  f"the ranks were:\n{e.stderr}")
            ok = False
            summary.setdefault(f"{stage}-{G}", {})["exit"] = {"timeout"}
            continue
        for r in res:
            if r.returncode != 0 or "PROBE" not in r.stdout:
                err = "\n".join(
                    line for line in r.stderr.splitlines()
                    if not line.startswith(("[W", "  File", "Extension")))
                print(f"{stage} G={G} rank failed ({r.returncode}):\n"
                      f"{err[-2500:]}")
                ok = False
                summary.setdefault(f"{stage}-{G}", {}).setdefault(
                    "exit", set()).add(json.dumps(r.returncode))
                continue
            got = json.loads(r.stdout.split("PROBE", 1)[1])
            print(json.dumps(got))
            for tag, cases in got["cases"].items():
                for k, v in cases.items():
                    if k != "groups" and v != "ok":
                        ok = False
                    summary.setdefault(f"{stage}-{G}:{tag}", {}).setdefault(
                        k, set()).add(
                        json.dumps(v))
    print(json.dumps({"ok": ok, "summary": {
        t: {k: sorted(v) for k, v in c.items()}
        for t, c in summary.items()}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

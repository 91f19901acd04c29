"""Where each member of the robustness grid's populations first departs
from its standalone run, and which single ops are batch-invariant.

    PYTHONPATH=src python scripts/member_drift.py [--device cpu]

For every (workload, fault) cell of `repro_torch.paper.robustness`, runs
the trust/fedavg pair as one population and as two standalone
federations, one round at a time, and prints the first round at which a
member's state differs bitwise from its standalone run's: the round, the
state leaf, the largest absolute and relative difference ("none": bit
for bit over every round, NaN in the same places counting as equal).
Then checks, at the grid's shapes (9 members, N = 159,010), whether
single ops give each member's slice the same bits under
``torch.func.vmap`` as alone: the row reductions the round uses, those
of `repro_torch.core.member_ops`, and the batched GEMM of local
training.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.api import Federation
from repro_torch.core.member_ops import gram, row_sq_sum
from repro_torch.device import resolve_device
from repro_torch.paper import robustness
from repro_torch.pop import PopulationEngine


def first_departures(workload: str, fault: str, dev) -> dict:
    """{member: (round, leaf, max abs, max rel)} of the first bitwise
    difference between the population's member and its standalone run."""
    base = robustness._specs(False)[workload]
    members = robustness.cell_specs(base, robustness.FAULTS[workload][fault])
    pop = PopulationEngine(members, device=dev)
    seq = [Federation.from_spec(s, device=dev) for s in members]
    first = {}
    for r in range(base.rounds):
        pop.run_scanned(1, eval_final=False)
        pst = pop.state.tensors()
        for b, fed in enumerate(seq):
            fed.engine.run_scanned(1, eval_final=False)
            if b in first:
                continue
            for k, v in fed.engine.state.tensors().items():
                pv = pst[k][b][tuple(slice(0, n) for n in v.shape)]
                if not (torch.equal(pv.isnan(), v.isnan()) and torch.equal(
                        pv.nan_to_num(0.0), v.nan_to_num(0.0))):
                    d = (pv.double() - v.double()).abs().max().item()
                    first[b] = (r, k, d, d / max(
                        v.double().abs().max().item(), 1e-30))
                    break
    return first


def op_checks(dev) -> dict:
    """{op: whether vmap over 2 members gives each slice its own bits}."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 9, 159010), generator=g, device=dev)
    ops = {
        "vector_norm over N": lambda u: torch.linalg.vector_norm(u, dim=1),
        "(u * u).sum over N": lambda u: (u * u).sum(1),
        "sum over members": lambda u: u.sum(0),
        "mean over a batch of 64": lambda u: u[:, :64].mean(1),
        "member_ops.row_sq_sum": row_sq_sum,
        "member_ops.row_sq_sum of a leaf": lambda u: row_sq_sum(
            u[:, :156800]),
        "member_ops.gram": gram,
    }
    out = {name: all(torch.equal(b, f(u)) for b, u in
                     zip(torch.func.vmap(f)(x), x))
           for name, f in ops.items()}
    a = torch.randn((2, 9, 64, 784), generator=g, device=dev)
    w = torch.randn((2, 9, 784, 200), generator=g, device=dev)
    out["bmm (9, 64, 784) @ (9, 784, 200)"] = all(
        torch.equal(b, torch.bmm(ai, wi))
        for b, ai, wi in zip(torch.func.vmap(torch.bmm)(a, w), a, w))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    dev = resolve_device(ap.parse_args().device)
    for workload, faults in robustness.FAULTS.items():
        for fault in faults:
            first = first_departures(workload, fault, dev) or "none"
            print(f"{workload}/{fault}: first departure (round, leaf, max "
                  f"abs, rel): {first}", flush=True)
    for name, same in op_checks(dev).items():
        print(f"op {name}: batch-invariant {same}", flush=True)


if __name__ == "__main__":
    main()

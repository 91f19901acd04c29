"""The device-scale engine of the port: the paper's §IV-D asynchronous
clustered federation, one cluster round at a time, on the card.

The state of the whole federation is one `FleetState` of tensors on
``device``: twins, reputations, channel states, the stacked cluster models
and the global model (both flat float32, `kernels.ops` layout), the
per-cluster update rounds, the Eqn-12 queue and the round counter.

`DeviceScaleEngine._fleet_round` is one asynchronous cluster round: the
Alg.-2 bound, the padded batch gather, batched local SGD of all members,
Eqns 4-5 trust, Eqn 6 + Eqn 19 aggregation in one pass of the CUDA
``trust_aggregate_global`` kernel, Eqns 7-8 energy, the twin update and the
Eqn-12 queue.  Ragged clusters run as one fixed-shape round over a padded
(n_clusters, M) membership table whose padding slots hold the sentinel id
``n`` (`core.twin.take` / `put` read fills and drop writes for it).

Two entry points drive the round:

  run           the host event heap (per-round evaluation, ``sim_seconds``
                cutoffs); the controller's ``select`` runs on the host.
  run_scanned   exactly K rounds with the controller on the card: cluster
                scheduling by argmin over the per-cluster event times, the
                policy's step, the round and the queue stay on the device,
                and the per-round metrics are read back once at the end,
                where the float64 energy tally is rebuilt from the float32
                consumptions by sequential host additions.

In both, the local-step count ``a`` is read to the host once per round: it
sets the number of SGD steps.  (A sync-free round, a masked loop of
``n_actions`` steps under a CUDA graph, is queued in ROADMAP.md.)

Randomness: every per-round draw (batch rows, channel noise, next channel
states) is a counter-based function of (seed, round, stream, device id,
index) from `repro_torch.rng`, through the ``draws`` attribute; the parity
tests replace it with the JAX package's draws.  Init-time draws come from
CPU generators seeded from ``spec.seed``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.control import policy as ctl_policy
from repro_torch.control import queue as ctl_queue
from repro_torch.core.clustering import (cluster_devices, ensure_nonempty,
                                         padded_membership, tolerance_bound)
from repro_torch.core.energy import (channel_cdf, draw_noise,
                                     round_energy, step_channel)
from repro_torch.core.trust import (belief, gradient_diversity,
                                    learning_quality, staleness_weights,
                                    trust_weights, update_reputation)
from repro_torch.core.twin import (TwinState, calibrate, calibrated_freq,
                                   draw_twins, member_view,
                                   observe_round_members, put,
                                   sample_deviation, take)
from repro_torch.data.federated import (dirichlet_partition,
                                        padded_partition,
                                        sample_member_batch)
from repro_torch.data.synthetic import (SyntheticClassification,
                                        make_classification)
from repro_torch.kernels.ops import flatten_rows

from .components import ControllerCtx
from .records import FLTrace, RoundRecord
from .registry import register_engine
from .spec import DEVICE_SCALE, FederationSpec


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Without a card, only an explicit ``device="cpu"`` runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run its plain versions on the CPU")
    if dev.type == "cuda":
        # float32 products in full precision (Eqn 4's Gram matrix, the MLP)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


@dataclasses.dataclass
class FleetState:
    """Struct-of-arrays state of the whole federation, tensors on one
    device.  The round replaces the small tensors and writes the new
    cluster model into ``cluster_flat`` in place."""
    twins: TwinState            # per-device digital twins (n,)
    rep: torch.Tensor           # (n,) Eqn-5 reputations
    channel: torch.Tensor       # (n,) Markov channel state, int64
    cluster_flat: torch.Tensor  # (n_clusters, N) stacked cluster models
    global_flat: torch.Tensor   # (N,) Eqn-19 global model
    cluster_ts: torch.Tensor    # (n_clusters,) last-update round, f32
    queue: torch.Tensor         # () Eqn-12 Lyapunov deficit backlog, f32
    round: torch.Tensor         # () global round counter, int64

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the state by name (twins as ``twins.<field>``)."""
        out = {f"twins.{f.name}": getattr(self.twins, f.name)
               for f in dataclasses.fields(TwinState)}
        out.update({f.name: getattr(self, f.name)
                    for f in dataclasses.fields(self) if f.name != "twins"})
        return out


class RoundDraws(NamedTuple):
    """The random numbers one round consumes."""
    sel: torch.Tensor       # (M, local_batch) int64 dataset rows per member
    noise: torch.Tensor     # (M,) f32 Poisson channel-noise counts
    channel: torch.Tensor   # (n,) int64 next channel state of every device


def fleet_state_from_numpy(tree, device) -> FleetState:
    """The port's `FleetState` from the JAX package's (leaves as numpy, or
    anything ``np.asarray`` takes; the PRNG key is not carried)."""
    dev = torch.device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    def flat(params, rows: bool):
        tree_ = {k: torch.as_tensor(np.array(v), dtype=torch.float32)
                 for k, v in params.items()}
        if not rows:
            tree_ = {k: v[None] for k, v in tree_.items()}
        out = flatten_rows(tree_)
        return (out if rows else out[0]).to(dev)

    twins = TwinState(**{f.name: t(getattr(tree.twins, f.name))
                         for f in dataclasses.fields(TwinState)})
    return FleetState(
        twins=twins, rep=t(tree.rep), channel=t(tree.channel, torch.int64),
        cluster_flat=flat(tree.cluster_params, True),
        global_flat=flat(tree.global_params, False),
        cluster_ts=t(tree.cluster_ts), queue=t(tree.queue),
        round=t(tree.round, torch.int64))


def _row(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``t[c]`` for a 0-d index tensor on the device, without reading it
    back to the host."""
    return t.index_select(0, c.reshape(1))[0]


def _set_row(t: torch.Tensor, c: torch.Tensor, v) -> None:
    """``t[c] = v`` in place, ``c`` a 0-d index tensor on the device."""
    t.index_copy_(0, c.reshape(1), v.reshape((1,) + tuple(t.shape[1:])))


def _as_data(data, device) -> SyntheticClassification:
    """The dataset's ``x``/``y`` (tensors, or arrays such as the JAX
    package's) as tensors on ``device``."""
    def t(a, dtype):
        a = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return a.to(device=device, dtype=dtype)
    return SyntheticClassification(x=t(data.x, torch.float32),
                                   y=t(data.y, torch.int64), prototypes=None)


class DeviceScaleEngine:
    """Discrete-event asynchronous clustered FL over a device fleet."""

    def __init__(self, spec: FederationSpec, data, parts, *, controller,
                 aggregator, task, device=None, assign=None, state=None):
        if spec.scale != DEVICE_SCALE:
            raise ValueError(f"DeviceScaleEngine runs scale={DEVICE_SCALE!r}"
                             f", got {spec.scale!r}")
        if not getattr(aggregator, "supports_mask", False):
            raise NotImplementedError(
                f"aggregator {type(aggregator).__name__} is not mask-aware; "
                "the port runs only the padded round (ROADMAP.md, queue 1, "
                "item 4)")
        dev = resolve_device(device)
        self.device = dev
        self.spec = spec
        self.data = _as_data(data, dev)
        self.parts = parts
        self.controller = controller
        self.aggregator = aggregator
        self.task = task

        n = spec.fleet.n_devices
        C = spec.clustering.n_clusters
        gen = rng.generator(spec.seed, rng.INIT)
        twins = draw_twins(n, gen)
        twins = sample_deviation(
            twins, torch.rand((n,), generator=gen) * spec.fleet.dt_max_dev)
        twins = twins.replace(data_size=torch.tensor(
            [len(p) for p in parts], dtype=torch.float32))
        init_idx = torch.randperm(n, generator=gen)[:C]
        if assign is None:
            assign, _ = cluster_devices(twins, C, init_idx)
        self.assign = ensure_nonempty(np.asarray(assign), C)
        table, mask = padded_membership(self.assign, C)
        self._member_table = table.to(dev)
        self._member_mask = mask.to(dev)
        self._member_mask_f = mask.to(torch.float32).to(dev)

        self.malicious = np.zeros(n, bool)
        n_mal = int(spec.fleet.malicious_frac * n)
        if n_mal:
            self.malicious[torch.randperm(n, generator=gen)[:n_mal].numpy()] \
                = True
        # the fault model's Byzantine subsets are not ported (an active
        # FaultSpec is rejected), so the label flippers are the whole set
        self._malicious_dev = torch.as_tensor(self.malicious,
                                              dtype=torch.float32,
                                              device=dev)

        gflat = task.init(gen, dim=self.data.x.shape[1])
        if state is None:
            state = FleetState(
                twins=TwinState(**{f.name: getattr(twins, f.name).to(dev)
                                   for f in dataclasses.fields(TwinState)}),
                rep=torch.ones((n,), device=dev),
                channel=torch.zeros((n,), dtype=torch.int64, device=dev),
                cluster_flat=gflat.expand(C, -1).clone().to(dev),
                global_flat=gflat.to(dev),
                cluster_ts=torch.zeros((C,), device=dev),
                queue=ctl_queue.init_leaf(device=dev),
                round=torch.zeros((), dtype=torch.int64, device=dev))
        self.state = state
        self._queue_per_slot = ctl_queue.per_slot_of(controller)

        part_idx, part_len = padded_partition(parts)
        self._part_idx = part_idx.to(dev)
        self._part_len = part_len.to(dev)
        self._trans_cdf = channel_cdf(spec.channel.p_good).to(dev)
        self._dev_ids = torch.arange(n, device=dev)
        self._batch_idx = torch.arange(spec.local_batch, device=dev)
        self._cidx = torch.arange(C, device=dev)
        self._n_actions = int(getattr(controller, "n_actions", 10))
        self._needs_ctx = bool(getattr(controller, "needs_ctx", True))
        self._rounds = 0
        # cumulative energy in float64 on the host, from the float32
        # per-round consumptions
        self._energy_used = 0.0
        # per-cluster next-event times of the scanned path, carried across
        # run_scanned calls so run_scanned(K) twice continues run_scanned(2K)
        self._scan_times = torch.zeros((C,), device=dev)
        # the per-round random draws: (state, members) -> RoundDraws
        self.draws = self._own_draws

    @classmethod
    def from_spec(cls, spec: FederationSpec, *, controller, aggregator, task,
                  device=None, data=None, parts=None, assign=None,
                  state=None) -> "DeviceScaleEngine":
        """Build from a spec; ``data``/``parts``/``assign``/``state``
        override what the engine would generate from ``spec.seed``."""
        if data is None or parts is None:
            data, parts = default_device_data(spec)
        return cls(spec, data, parts, controller=controller,
                   aggregator=aggregator, task=task, device=device,
                   assign=assign, state=state)

    # ------------------------------------------------------------------ #
    # randomness
    # ------------------------------------------------------------------ #
    def _own_draws(self, state: FleetState, members) -> RoundDraws:
        seed, r = self.spec.seed, state.round
        u = rng.uniform(seed, r, rng.BATCH, members[:, None],
                        self._batch_idx[None, :])
        sel = sample_member_batch(u, self._part_idx, self._part_len, members)
        ch_m = take(state.channel, members, 0)
        noise = draw_noise(rng.uniform(seed, r, rng.NOISE, members, 0), ch_m)
        channel = step_channel(
            rng.uniform(seed, r, rng.CHANNEL, self._dev_ids, 0),
            state.channel, self._trans_cdf)
        return RoundDraws(sel=sel, noise=noise, channel=channel)

    # ------------------------------------------------------------------ #
    # the round
    # ------------------------------------------------------------------ #
    def _cluster_freq_table(self, twins: TwinState) -> torch.Tensor:
        """Straggler (min) calibrated frequency of every cluster, (C,)."""
        fmat = take(calibrated_freq(twins), self._member_table,
                    float("inf"))
        fmin = torch.where(self._member_mask, fmat, float("inf")).min(
            dim=1).values
        return torch.where(self._member_mask.any(dim=1), fmin, 1.0)

    def _fleet_round(self, state: FleetState, c: torch.Tensor, a_raw):
        """One asynchronous cluster round (paper §IV-D), state -> state.

        ``c`` is the cluster, a 0-d int64 tensor on the device; ``a_raw``
        the controller's raw choice (int or 0-d tensor).  Returns the new
        state and the round's metrics as 0-d device tensors."""
        spec, task, twins = self.spec, self.task, state.twins
        dev = self.device
        members = _row(self._member_table, c)
        mask = _row(self._member_mask, c)
        mask_f = _row(self._member_mask_f, c)
        cnt = torch.clamp(mask_f.sum(), min=1.0)

        # --- controller choice capped by the Alg.-2 tolerance bound
        cluster_freq = self._cluster_freq_table(twins)
        if not torch.is_tensor(a_raw):
            a_raw = torch.full((), int(a_raw), dtype=torch.int32, device=dev)
        a_req = torch.clamp(a_raw.to(torch.int32), 1, self._n_actions)
        t_ref = a_req.to(torch.float32) / torch.clamp(cluster_freq.max(),
                                                      min=1e-6)
        alpha = torch.clamp(
            spec.clustering.alpha0 + spec.clustering.alpha_growth
            * state.round.to(torch.float32), max=1.0)
        a = tolerance_bound(a_req, _row(cluster_freq, c), t_ref, alpha)
        a = torch.clamp(a, 1, self._n_actions)
        steps = int(a)              # the round's one read back to the host

        # --- local batches
        draws = self.draws(state, members)
        x = self.data.x[draws.sel]
        y = self.data.y[draws.sel]
        mal_m = take(self._malicious_dev, members, 0.0)
        y = torch.where(mal_m[:, None] > 0.5, task.corrupt_labels(y), y)

        # --- `steps` local SGD steps on every member, from the cluster model
        stacked = _row(state.cluster_flat, c).expand(members.shape[0], -1)
        new = task.local_train(stacked, x, y, spec.lr, steps)

        # --- trust (Eqns 4-5)
        upd = new - stacked
        q = learning_quality(upd, mask)
        div = gradient_diversity(upd, mask)
        b = belief(member_view(twins, members), q, spec.channel.pkt_fail,
                   div)
        rep_m = update_reputation(take(state.rep, members, 1.0), b,
                                  spec.channel.pkt_fail, spec.iota)
        rep = put(state.rep, members, rep_m)
        w = trust_weights(rep_m, mask)

        # --- losses, energy (Eqns 7-8), twins
        losses = task.losses(new, x, y)
        true_freq = take(twins.freq + twins.freq_dev, members, 1.0)
        ch_m = take(state.channel, members, 0)
        e = round_energy(a.to(torch.float32), true_freq, ch_m,
                         draws.noise) * mask_f
        consumed = e.sum()
        twins = observe_round_members(twins, members, losses, e,
                                      self._malicious_dev)
        if spec.fleet.calibrate_dt:
            twins = calibrate(twins)

        # --- Eqn 6 + Eqn 19: cluster aggregate and staleness-weighted
        # global model (async pull: the cluster adopts the global model)
        rnd = state.round + 1
        ts = state.cluster_ts.clone()
        _set_row(ts, c, rnd.to(torch.float32))
        staleness = rnd.to(torch.float32) - ts
        cflat = state.cluster_flat
        gflat = self.aggregator.aggregate_with_global(
            new, w, mask_f, cflat, staleness_weights(staleness), c)
        _set_row(cflat, c, gflat)

        # --- Eqn 12 with the realized consumption (+inf per slot: q = 0)
        queue = ctl_queue.queue_advance(state.queue, consumed,
                                        self._queue_per_slot)
        # --- round duration from the post-calibration straggler frequency
        dur = a.to(torch.float32) / torch.clamp(
            _row(self._cluster_freq_table(twins), c), min=1e-6)

        new_state = FleetState(
            twins=twins, rep=rep, channel=draws.channel, cluster_flat=cflat,
            global_flat=gflat, cluster_ts=ts, queue=queue, round=rnd)
        metrics = {"a": a, "dur": dur, "consumed": consumed,
                   "loss": (losses * mask_f).sum() / cnt}
        return new_state, metrics

    # ------------------------------------------------------------------ #
    # controller features
    # ------------------------------------------------------------------ #
    def _ctl_features(self, state: FleetState, c) -> Dict[str, torch.Tensor]:
        """The f32 scalars a frequency controller scores from, over the
        padded membership row of cluster ``c`` (0-d device tensors)."""
        twins = state.twins
        members = _row(self._member_table, c)
        mask = _row(self._member_mask, c)
        cnt = torch.clamp(_row(self._member_mask_f, c).sum(), min=1.0)
        loss_m = take(twins.loss, members, 0.0)
        loss = torch.where(mask, loss_m, 0.0).sum() / cnt
        loss = torch.nan_to_num(loss, nan=0.0, posinf=2.3)
        f_m = take(calibrated_freq(twins), members, 0.0)
        mean_freq = torch.where(mask, f_m, 0.0).sum() / cnt
        ch_m = take(state.channel, members, 1)
        good = torch.where(mask, (ch_m == 0).to(torch.float32), 0.0).sum() \
            / cnt
        return {"cluster_loss": loss, "mean_freq": mean_freq,
                "channel_good_frac": good,
                "cluster_freq": _row(self._cluster_freq_table(twins), c)}

    def _ctx(self, c: int) -> ControllerCtx:
        f = self._ctl_features(self.state, self._cidx[c])
        loss, freq, mean_freq, good = torch.stack(
            [f["cluster_loss"], f["cluster_freq"], f["mean_freq"],
             f["channel_good_frac"]]).tolist()
        return ControllerCtx(round=self._rounds, cluster=c,
                             cluster_loss=loss, cluster_freq=freq,
                             mean_freq=mean_freq, channel_good_frac=good,
                             energy_used=self._energy_used)

    def _null_ctx(self, c: int) -> ControllerCtx:
        """Read-free ctx for ``needs_ctx=False`` controllers."""
        return ControllerCtx(round=self._rounds, cluster=c, cluster_loss=0.0,
                             cluster_freq=1.0, mean_freq=1.0,
                             channel_good_frac=1.0, energy_used=0.0)

    # ------------------------------------------------------------------ #
    # K rounds with the controller on the device
    # ------------------------------------------------------------------ #
    def run_scanned(self, K: int, *, eval_final: bool = True) -> FLTrace:
        """Run exactly K asynchronous cluster rounds, scheduled on the
        device by argmin over the per-cluster event times (ties go to the
        lowest cluster index, as the event heap's (t, c) order does), with
        the controller's `scan_policy` choosing each round's ``a``.  The
        per-round metrics are read back once, after round K; ``eval_final``
        appends one evaluation record of the final global model.
        Consecutive calls continue the schedule."""
        pol = self.controller.scan_policy()
        state, times, ctl = self.state, self._scan_times, pol.state
        energy = torch.full((), self._energy_used, dtype=torch.float32,
                            device=self.device)
        rows = []
        for _ in range(int(K)):
            c = torch.argmin(times)
            t = _row(times, c)
            feats = self._ctl_features(state, c)
            cobs = ctl_policy.CtlObs(
                round=state.round, cluster=c, queue=state.queue,
                cluster_loss=feats["cluster_loss"],
                cluster_freq=feats["cluster_freq"],
                mean_freq=feats["mean_freq"],
                channel_good_frac=feats["channel_good_frac"],
                energy_used=energy)
            a_raw, ctl = pol.step(ctl, cobs)
            state, m = self._fleet_round(state, c, a_raw)
            times = times.clone()
            _set_row(times, c, t + m["dur"])
            energy = energy + m["consumed"]
            rows.append(torch.stack([t, c.to(torch.float32),
                                     m["a"].to(torch.float32), m["dur"],
                                     m["consumed"], m["loss"]]))
        self.state = state
        self._scan_times = times
        ys = torch.stack(rows).cpu().numpy()     # the one end-of-run read
        return self._emit_scanned_trace(ys, eval_final)

    def _emit_scanned_trace(self, ys: np.ndarray, eval_final: bool
                            ) -> FLTrace:
        """Records from the (K, 6) float32 rows (t, cluster, a, dur,
        consumed, loss); the float64 energy tally adds the float32
        consumptions one by one, as the event loop does."""
        K = ys.shape[0]
        base = self._rounds
        self._rounds += K
        cum = []
        for ci in ys[:, 4]:
            self._energy_used += float(ci)
            cum.append(self._energy_used)
        sync_queue = getattr(self.controller, "sync_queue", None)
        if sync_queue is not None:          # host controller adopts the
            sync_queue(self.state.queue)    # device-resident backlog
        trace = FLTrace()
        for i in range(K):
            trace.append(RoundRecord(
                t=float(ys[i, 0]), round=base + i + 1,
                cluster=int(ys[i, 1]), a=int(ys[i, 2]),
                loss=float(ys[i, 5]), acc=None, energy=cum[i],
                agg_count=base + i + 1))
        if eval_final and K:
            ev = self.task.evaluate(self.state.global_flat, self.data)
            trace.append(RoundRecord(
                t=float(ys[-1, 0]) + float(ys[-1, 3]), round=self._rounds,
                cluster=int(ys[-1, 1]), a=int(ys[-1, 2]), loss=ev["loss"],
                acc=ev["acc"], energy=self._energy_used,
                agg_count=self._rounds))
        return trace

    # ------------------------------------------------------------------ #
    # the host event heap
    # ------------------------------------------------------------------ #
    def run(self, eval_every: float = 1.0,
            max_rounds: Optional[int] = None) -> FLTrace:
        if self.spec.execution == "scanned":
            K = max_rounds if max_rounds is not None else self.spec.rounds
            return self.run_scanned(K)
        spec = self.spec
        trace = FLTrace()
        events = [(0.0, c) for c in range(spec.clustering.n_clusters)]
        heapq.heapify(events)
        t = 0.0
        next_eval = 0.0
        done = 0
        while events and t < spec.sim_seconds:
            if max_rounds is not None and done >= max_rounds:
                break
            t, c = heapq.heappop(events)
            if t >= spec.sim_seconds:
                break
            ctx = self._ctx(c) if self._needs_ctx else self._null_ctx(c)
            a_raw = int(self.controller.select(ctx))
            self.state, m = self._fleet_round(self.state, self._cidx[c],
                                              a_raw)
            self._rounds += 1
            done += 1
            a, dur, consumed, loss = torch.stack(
                [m["a"].to(torch.float32), m["dur"], m["consumed"],
                 m["loss"]]).tolist()
            self._energy_used += consumed
            self.controller.observe(None, consumed, loss)
            heapq.heappush(events, (t + dur, c))
            if t >= next_eval:
                ev = self.task.evaluate(self.state.global_flat, self.data)
                trace.append(RoundRecord(
                    t=t, round=self._rounds, cluster=c, a=int(a),
                    loss=ev["loss"], acc=ev["acc"],
                    energy=self._energy_used, agg_count=self._rounds))
                next_eval = t + eval_every
        return trace


def default_device_data(spec: FederationSpec):
    """Synthetic non-IID federated data from the task params, generated
    from ``spec.seed``: the MNIST-shaped prototype mixture, partitioned by
    a Dirichlet draw over the labels."""
    p = spec.task.params
    data = make_classification(rng.generator(spec.seed, rng.DATA),
                               n=p.get("n_samples", 4096),
                               dim=p.get("dim", 784))
    parts = dirichlet_partition(data.y.numpy(), spec.fleet.n_devices,
                                alpha=p.get("dirichlet_alpha", 0.5),
                                seed=spec.seed)
    return data, parts


register_engine(DEVICE_SCALE)(DeviceScaleEngine)

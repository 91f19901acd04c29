"""Cluster-major fleets: the multi-device engine over ``torch.distributed``.

The port's counterpart of the JAX package's ``repro.api.cluster_engine``.
`ClusterMajorEngine` re-indexes the fleet **cluster-major** at build time:
slot ``c*S + j`` holds device ``member_table[c, j]`` (ascending original
ids; the sentinel ``n`` marks padding), so a cluster's members are one
contiguous block of slots.  The mesh is one axis of ranks, one shard a
rank (`repro_torch.api.placement`): rank g keeps only its ``C_loc``
cluster rows and their ``C_loc*S`` slots of every fleet-axis leaf
(twins, reputations, channel states, the cluster models and their update
rounds); the global model, the queue, the round counter and the per-round
tables below are replicated.

A round (`_fleet_round`) is the unsharded engine's split into:

  * replicated pre-work on every rank: the Alg.-2 bound from the
    replicated frequency table, then one host read of (c, a) on each rank;
  * the owning rank's member round (batch gather, local SGD, Eqns 4-5
    trust, Eqn-6 aggregation through the masked ``trust_aggregate``
    kernel, `dp_aggregate` or the masked robust rule, energy, faults),
    over its slot block; other ranks skip it;
  * exactly **two** collectives, each a SUM ``all_reduce`` of one flat
    float32 tensor: (1) consumed energy, the loss, the empty flag, the
    straggle factor, the Eqn-19 normalizer, the frequency table, the
    controller's feature and channel tables; (2) the Eqn-19 partial sum of
    the rank's (C_loc, N) cluster rows through the unmasked
    ``trust_aggregate`` kernel.  A value with one contributor travels as
    zeros from the other ranks, so the sum is exact.

Every rank then holds the same replicated values, so each schedules the
same next cluster (`run_scanned`'s argmin, `run`'s host event heap) with
no further traffic.  The scanned path reads the controller's features
from the replicated tables; the event path's context is one more (4,)
all-reduce (`_ctx`), as in the JAX package.

The channel draws of the port are keyed per device id (`repro_torch.rng`),
so a rank draws its own slots' next states and gets the unsharded values;
injected draws (``draws``, the parity tests' JAX draws) are called with a
view holding the original-order channel of the rank's devices and return
the full fleet's, of which the rank keeps its slots.

A stable inverse permutation (``slot_of_orig``) keeps the public surface
in original device ids: `resumable_state` / `restore_resumable` speak the
unsharded checkpoint layout (checkpoints move between engines, and to and
from the JAX package), and the ``rep`` / ``twins`` / ``channel`` views
assemble the original order by one zero-padded SUM all-reduce, outside the
round, so every rank returns the same tensor (every rank must call them).

Arbitrary ``(n_devices, n_clusters)`` run on any world size: the cluster
axis pads to ``ceil(C/G)*G`` with sentinel clusters (event time +inf,
Eqn-19 weight 0) and the fleet axis to ``C_pad * S`` sentinel slots; the
padding is logged at build.  Across ranks the schedule, actions, counters
and the frequency table are exact; the Eqn-19 sums reassociate, so losses
and energies match the unsharded engine to rtol ~1e-5.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import types
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.control import policy as ctl_policy
from repro_torch.control import queue as ctl_queue
from repro_torch.core.clustering import tolerance_bound
from repro_torch.core.energy import step_channel
from repro_torch.core.twin import (MEMBER_FILLS, TwinState, calibrate,
                                   calibrated_freq, take)
from repro_torch.kernels.trust_aggregate import trust_aggregate

from . import placement
from .components import ControllerCtx
from .engine import (DeviceScaleEngine, FleetState, _row, _with_row,
                     fleet_state_from_numpy, fleet_tree)
from .spec import ShardingSpec

log = logging.getLogger("repro_torch.cluster")

_STALE_BASE = math.e / 2        # Eqn-19 decay base (trust.staleness_weights)
_EPS = 1e-8                     # its normalizer epsilon
_TWIN_FIELDS = tuple(f.name for f in dataclasses.fields(TwinState))


@dataclasses.dataclass
class ClusterMajorState(FleetState):
    """A rank's share of the federation: twins, rep and channel over its
    ``C_loc*S`` slots, ``cluster_flat`` / ``cluster_ts`` over its ``C_loc``
    cluster rows, the rest replicated; plus the replicated tables the next
    round and the controller read without a collective, all (C_pad, ...)
    over every cluster (sentinel rows hold 1.0 and zeros)."""
    ftbl: torch.Tensor      # straggler (min) calibrated frequency
    ch3: torch.Tensor       # (3,) fleet channel-state fractions
    feats: torch.Tensor     # (C_pad, 3) mean twin loss, mean calibrated
                            # frequency, good-channel fraction
    tau: torch.Tensor       # hidden-activation mean of each cluster model


class ClusterMajorEngine(DeviceScaleEngine):
    """`DeviceScaleEngine` on a cluster-major layout over one axis of
    ``torch.distributed`` ranks.

    Selected by ``ShardingSpec.impl='shard_map'`` (the default for 1-D
    meshes) through ``DeviceScaleEngine.from_spec``."""

    def __init__(self, spec, data, parts, *, controller, aggregator, task,
                 device=None, assign=None, state=None):
        if not bool(getattr(aggregator, "supports_mask", False)):
            raise ValueError(
                f"aggregator {type(aggregator).__name__} has "
                "supports_mask=False (exact-shape compiles); the "
                "cluster-major engine runs the padded fixed-shape round "
                "only — pick a mask-aware rule or impl='gspmd'")
        # build the exact unsharded engine first (same seeds, same
        # k-means / membership / Byzantine tables), then permute
        base = dataclasses.replace(spec, sharding=ShardingSpec())
        super().__init__(base, data, parts, controller=controller,
                         aggregator=aggregator, task=task, device=device,
                         assign=assign, state=state)
        self.spec = spec
        n = spec.fleet.n_devices
        C = spec.clustering.n_clusters
        self.placement = placement.resolve(spec.sharding, n_devices=n,
                                           n_clusters=C, device=self.device)
        self._group = self.placement.group
        G, g = self.placement.world_size, self.placement.rank
        S = int(self._member_table.shape[1])
        C_pad = -(-C // G) * G          # auto-pad: sentinel clusters
        n_pad = C_pad * S               # ... and sentinel device slots
        self._n, self._C, self._S, self._G, self._g = n, C, S, G, g
        self._C_pad, self._C_loc, self._n_pad = C_pad, C_pad // G, n_pad

        # every rank draws its own slots' channel from the transition row
        # of their state; the check keeps the JAX package's contract
        cdf = self._trans_cdf
        if not bool((cdf == cdf[0]).all()):
            raise ValueError(
                "cluster-major engine: the channel transition matrix must "
                "be state-independent (identical rows) so every shard can "
                "reproduce the original-order channel draw; got distinct "
                "rows — use impl='gspmd'")

        # slot -> original device id (sentinel n at padding) and its
        # stable inverse; member_table rows are ascending original ids
        oos = np.full((n_pad,), n, np.int64)
        oos[:C * S] = self._member_table.cpu().numpy().reshape(-1)
        real = oos < n
        soo = np.zeros((n,), np.int64)
        soo[oos[real]] = np.nonzero(real)[0]
        self._oos = torch.from_numpy(oos)
        self._slot_of_orig = torch.from_numpy(soo)
        if C_pad != C or n_pad != n:
            log.info(
                "cluster-major padding: %d clusters -> %d and %d devices "
                "-> %d slots (mesh %s, %d member slots per cluster); "
                "sentinel clusters carry event time +inf and Eqn-19 "
                "weight 0, sentinel device slots are masked everywhere",
                C, C_pad, n, n_pad, tuple(spec.sharding.mesh), S)

        # this rank's block of slots and cluster rows
        dev = self.device
        C_loc = self._C_loc
        blk = slice(g * C_loc * S, (g + 1) * C_loc * S)
        self._oos_l = self._oos[blk].to(dev)
        self._mskslot_l = self._oos_l < n
        self._real_l = torch.nonzero(self._mskslot_l).flatten()
        self._ids_l = self._oos_l[self._real_l]
        self._misb_l = take(self._misbehaving_dev, self._oos_l, 0.0)
        self._validc_f = (torch.arange(g * C_loc, (g + 1) * C_loc,
                                       device=dev) < C).to(torch.float32)
        self._cl_idx = torch.arange(C_loc, device=dev)
        self._x256 = self.data.x[:256]

        self._share_policy()
        self.state = self._with_tables(self._permute(self.state))
        self._scan_times = torch.cat([
            torch.zeros((C,), device=dev),
            torch.full((C_pad - C,), float("inf"), device=dev)])

    # ------------------------------------------------------------------ #
    # layout plumbing
    # ------------------------------------------------------------------ #
    def _block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (C_loc, ...) rows placed in a zero (C_pad, ...)
        tensor at its cluster block."""
        before = self._g * self._C_loc
        after = self._C_pad - before - self._C_loc
        z = lambda k: x.new_zeros((k,) + tuple(x.shape[1:]))  # noqa: E731
        return torch.cat([z(before), x, z(after)])

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's cluster rows of an original-order (C, ...) leaf,
        sentinel rows zero."""
        pad = x.new_zeros((self._C_pad - self._C,) + tuple(x.shape[1:]))
        lo = self._g * self._C_loc
        return torch.cat([x, pad])[lo:lo + self._C_loc].clone()

    def _permute(self, fleet: FleetState) -> FleetState:
        """Original-order (n, C) state -> this rank's slots and rows."""
        oos = self._oos_l
        twins = TwinState(**{f: take(getattr(fleet.twins, f), oos,
                                     MEMBER_FILLS[f]) for f in _TWIN_FIELDS})
        return FleetState(
            twins=twins, rep=take(fleet.rep, oos, 1.0),
            channel=take(fleet.channel.to(torch.int64), oos, 0),
            cluster_flat=self._rows(fleet.cluster_flat),
            global_flat=fleet.global_flat,
            cluster_ts=self._rows(fleet.cluster_ts.to(torch.float32)),
            queue=fleet.queue, round=fleet.round)

    def _local_tables(self, twins: TwinState, channel: torch.Tensor):
        """This rank's (C_loc,) straggler frequency table (bit-equal per
        row to the unsharded `_cluster_freq_table`: min is order-free) and
        its (C_loc, 3) controller features (`_ctl_features` of each row)."""
        shape = (self._C_loc, self._S)
        m = self._mskslot_l.reshape(shape)
        f = calibrated_freq(twins).reshape(shape)
        fmin = torch.where(m, f, float("inf")).min(dim=1).values
        ftbl = torch.where(m.any(dim=1), fmin, 1.0)
        cnt = torch.clamp(m.to(torch.float32).sum(1), min=1.0)
        loss = torch.where(m, twins.loss.reshape(shape), 0.0).sum(1) / cnt
        loss = torch.nan_to_num(loss, nan=0.0, posinf=2.3)
        mean_freq = torch.where(m, f, 0.0).sum(1) / cnt
        good = torch.where(m, (channel.reshape(shape) == 0).to(
            torch.float32), 0.0).sum(1) / cnt
        return ftbl, torch.stack([loss, mean_freq, good], 1)

    def _channel_counts(self, channel: torch.Tensor) -> torch.Tensor:
        return (F.one_hot(channel, 3).to(torch.float32)
                * self._mskslot_l[:, None]).sum(0)

    def _with_tables(self, st: FleetState) -> ClusterMajorState:
        """The replicated tables of a round-start state: one all-reduce
        (at build and after `restore_resumable`)."""
        ftbl, feats = self._local_tables(st.twins, st.channel)
        tau = torch.stack([
            self.task.hidden_mean(st.cluster_flat[i], self._x256)
            for i in range(self._C_loc)]) * self._validc_f
        C_pad = self._C_pad
        vec = torch.cat([self._block(ftbl), self._block(feats).reshape(-1),
                         self._block(tau), self._channel_counts(st.channel)])
        dist.all_reduce(vec, group=self._group)
        return ClusterMajorState(
            **{f.name: getattr(st, f.name)
               for f in dataclasses.fields(FleetState)},
            ftbl=vec[:C_pad],
            feats=vec[C_pad:4 * C_pad].reshape(C_pad, 3),
            tau=vec[4 * C_pad:5 * C_pad], ch3=vec[5 * C_pad:] / self._n)

    def _gather(self) -> FleetState:
        """The whole state in original device order (real clusters), on
        every rank: one zero-padded SUM all-reduce."""
        st, n = self.state, self._n
        real, ids = self._real_l, self._ids_l

        def scatter(v):
            buf = torch.zeros((n,), dtype=torch.float32, device=self.device)
            buf[ids] = v[real].to(torch.float32)
            return buf
        leaves = [getattr(st.twins, f) for f in _TWIN_FIELDS] + [
            st.rep, st.channel]
        vec = torch.cat([scatter(v) for v in leaves] + [
            self._block(st.cluster_flat).reshape(-1),
            self._block(st.cluster_ts)])
        dist.all_reduce(vec, group=self._group)
        k = len(_TWIN_FIELDS)
        rows = vec[:(k + 2) * n].reshape(k + 2, n)
        N = st.global_flat.shape[0]
        C, C_pad = self._C, self._C_pad
        flat = vec[(k + 2) * n:(k + 2) * n + C_pad * N].reshape(C_pad, N)
        return FleetState(
            twins=TwinState(**{f: rows[i] for i, f in
                               enumerate(_TWIN_FIELDS)}),
            rep=rows[k], channel=rows[k + 1].to(torch.int64),
            cluster_flat=flat[:C], global_flat=st.global_flat,
            cluster_ts=vec[-C_pad:][:C], queue=st.queue, round=st.round)

    # ------------------------------------------------------------------ #
    # the round
    # ------------------------------------------------------------------ #
    def _round_choice(self, state, c, a_raw) -> torch.Tensor:
        """The parent's choice over the replicated frequency table (its
        max over the *real* clusters only)."""
        spec = self.spec
        if not torch.is_tensor(a_raw):
            a_raw = torch.full((), int(a_raw), dtype=torch.int32,
                               device=self.device)
        a_req = torch.clamp(a_raw.to(torch.int32), 1, self._n_actions)
        t_ref = a_req.to(torch.float32) / torch.clamp(
            state.ftbl[:self._C].max(), min=1e-6)
        alpha = torch.clamp(
            spec.clustering.alpha0 + spec.clustering.alpha_growth
            * state.round.to(torch.float32), max=1.0)
        a = tolerance_bound(a_req, _row(state.ftbl, c), t_ref, alpha)
        return torch.clamp(a, 1, self._n_actions)

    def _draw_view(self, state):
        """What a draws callable reads of the state: the round, the
        original-order channel of this rank's devices (zeros elsewhere)
        and the model width."""
        ch = torch.zeros((self._n,), dtype=torch.int64, device=self.device)
        ch[self._ids_l] = state.channel[self._real_l]
        return types.SimpleNamespace(round=state.round, channel=ch,
                                     global_flat=state.global_flat)

    def _slot_channel(self, state, c: int) -> torch.Tensor:
        """The next channel state of this rank's slots (0 at sentinels)."""
        if self.draws == self._own_draws:
            u = rng.uniform(self.spec.seed, state.round, rng.CHANNEL,
                            self._oos_l, 0)
            nxt = step_channel(u, state.channel, self._trans_cdf)
            return torch.where(self._mskslot_l, nxt, 0)
        d = self.draws(self._draw_view(state), self._member_table[c])
        return take(d.channel, self._oos_l, 0)

    def _fleet_round(self, state: ClusterMajorState, c: torch.Tensor, a_raw,
                     members=None, mask=None):
        """One asynchronous cluster round on every rank (module
        docstring); ``members`` / ``mask`` are unused: the layout is the
        membership."""
        del members, mask
        spec, fm = self.spec, self.faults
        S, C_loc, C_pad = self._S, self._C_loc, self._C_pad
        a = self._round_choice(state, c, a_raw)
        # the round's one read back to the host, on every rank
        c_host, steps = (int(v) for v in torch.stack(
            [c.reshape(()).to(torch.int64), a.to(torch.int64)]).tolist())
        cl = c_host - self._g * C_loc
        mine = 0 <= cl < C_loc
        twins, rep = state.twins, state.rep
        loss, energy = twins.loss, twins.energy
        rnd = state.round + 1
        rnd_f = rnd.to(torch.float32)
        ts, cflat = state.cluster_ts, state.cluster_flat
        if mine:
            # --- the owner's member round over its slot block
            sl = slice(cl * S, (cl + 1) * S)
            draws = self.draws(self._draw_view(state),
                               self._member_table[c_host])
            channel = take(draws.channel, self._oos_l, 0)
            m = self._member_round(
                state, cflat[cl], a, steps, self._member_table[c_host],
                self._member_mask[c_host], self._member_mask_f[c_host],
                draws, block=sl)
            agg = self._eqn6(state, self._cl_idx[cl], m.new, m.upd, m.w,
                             m.mask, m.mask_f, m.cnt, draws)
            # --- slot-space updates (only the owner's block changes)
            rep, loss, energy = rep.clone(), loss.clone(), energy.clone()
            rep[sl] = torch.where(m.mask, m.rep_m, rep[sl])
            loss[sl] = torch.where(m.mask, m.losses, loss[sl])
            energy[sl] = energy[sl] + torch.where(m.mask, m.e, 0.0)
            ts, cflat = ts.clone(), cflat.clone()
            ts[cl] = rnd_f
            cflat[cl] = agg
            one = torch.ones((), device=self.device)
            # the straggle factor (straggle() multiplies its dur argument),
            # applied after the all-reduce as dur * factor: the parent's
            # product
            stretch = (fm.straggle(draws.straggle_u, one, m.mask)
                       if fm.may_straggle else one)
            empty = (m.mask_f.sum() < 0.5).to(torch.float32)
            head = torch.stack([m.e.sum(), m.loss, empty, stretch])
        else:
            channel = self._slot_channel(state, c_host)
            head = torch.zeros((4,), device=self.device)
        tw = twins.replace(loss=loss, energy=energy,
                           alpha=twins.alpha + (1.0 - self._misb_l),
                           beta=twins.beta + self._misb_l)
        if spec.fleet.calibrate_dt:
            tw = calibrate(tw)

        # --- all-reduce 1: the packed scalars, the frequency and feature
        # tables (disjoint blocks: exact) and the channel counts (integers)
        ftbl_l, feats_l = self._local_tables(tw, channel)
        w_un = _STALE_BASE ** (-(rnd_f - ts)) * self._validc_f
        vec = torch.cat([head, w_un.sum().reshape(1), self._block(ftbl_l),
                         self._block(feats_l).reshape(-1),
                         self._channel_counts(channel)])
        dist.all_reduce(vec, group=self._group)
        consumed, loss_m, empty, stretch, den = vec[:5]
        ftbl = vec[5:5 + C_pad]
        feats = vec[5 + C_pad:5 + 4 * C_pad].reshape(C_pad, 3)
        ch3 = vec[5 + 4 * C_pad:] / self._n

        # --- all-reduce 2: Eqn 19's staleness-weighted partial sum of this
        # rank's cluster rows, through the unmasked kernel
        w_norm = w_un / (den + _EPS)
        gflat = trust_aggregate(cflat.contiguous(), w_norm.contiguous())
        dist.all_reduce(gflat, group=self._group)
        if mine:
            cflat[cl] = gflat           # async pull: adopt the global model
        tau = _with_row(state.tau, c.reshape(()),
                        self.task.hidden_mean(gflat, self._x256))

        if fm.may_drop:
            # a cluster whose members all dropped skips its event, exactly
            # as the parent does; the channel and the round still advance
            empty_b = empty > 0.5

            def keep(old, new_):
                return torch.where(empty_b, old, new_)
            consumed = keep(torch.zeros_like(consumed), consumed)
            tw = TwinState(**{f: keep(getattr(twins, f), getattr(tw, f))
                              for f in _TWIN_FIELDS})
            rep = keep(state.rep, rep)
            cflat = keep(state.cluster_flat, cflat)
            gflat = keep(state.global_flat, gflat)
            ts = keep(state.cluster_ts, ts)
            ftbl = keep(state.ftbl, ftbl)
            # loss and frequency features read the twins (reverted); the
            # good-channel fraction reads the channel (advanced)
            feats = torch.cat([keep(state.feats[:, :2], feats[:, :2]),
                               feats[:, 2:]], 1)
            tau = keep(state.tau, tau)

        queue = ctl_queue.queue_advance(state.queue, consumed,
                                        self._queue_per_slot)
        dur = a.to(torch.float32) / torch.clamp(_row(ftbl, c), min=1e-6)
        if fm.may_straggle:
            dur = dur * stretch
        new_state = ClusterMajorState(
            twins=tw, rep=rep, channel=channel, cluster_flat=cflat,
            global_flat=gflat, cluster_ts=ts, queue=queue, round=rnd,
            ftbl=ftbl, ch3=ch3, feats=feats, tau=tau)
        return new_state, {"a": a, "dur": dur, "consumed": consumed,
                           "loss": loss_m}

    # ------------------------------------------------------------------ #
    # controller features: the tables (scanned path), one more all-reduce
    # for the host's context (event path)
    # ------------------------------------------------------------------ #
    def _ctl_features(self, state, c) -> Dict[str, torch.Tensor]:
        row = _row(state.feats, c)
        return {"cluster_loss": row[0], "mean_freq": row[1],
                "channel_good_frac": row[2],
                "cluster_freq": _row(state.ftbl, c)}

    def _scan_obs(self, state, c, feats) -> torch.Tensor:
        return ctl_policy.deploy_obs(
            feats["cluster_loss"], state.queue,
            state.round.to(torch.float32) / 100.0, _row(state.tau, c),
            state.round % 10, state.ch3, feats["mean_freq"])

    def _ctx(self, c: int) -> ControllerCtx:
        """The host controller's context of cluster ``c``: the owner's
        (loss, mean frequency, good fraction, tau) from the live state,
        replicated by one (4,) all-reduce (zeros from the other ranks)."""
        st = self.state
        cl = c - self._g * self._C_loc
        if 0 <= cl < self._C_loc:
            _, feats = self._local_tables(st.twins, st.channel)
            tau = self.task.hidden_mean(st.cluster_flat[cl], self._x256)
            vec = torch.cat([feats[cl], tau.reshape(1)])
        else:
            vec = torch.zeros((4,), device=self.device)
        dist.all_reduce(vec, group=self._group)
        loss, freq, mean_freq, good = torch.stack(
            [vec[0], st.ftbl[c], vec[1], vec[2]]).tolist()

        def obs():
            return ctl_policy.deploy_obs(
                vec[0], st.queue, st.round.to(torch.float32) / 100.0,
                vec[3], st.round % 10, st.ch3, vec[1])
        return ControllerCtx(round=self._rounds, cluster=c, obs=obs,
                             cluster_loss=loss, cluster_freq=freq,
                             mean_freq=mean_freq, channel_good_frac=good,
                             energy_used=self._energy_used)

    # ------------------------------------------------------------------ #
    # checkpoints and views: original device order at the boundary
    # ------------------------------------------------------------------ #
    def resumable_state(self) -> dict:
        """The unsharded layout (original device order, real clusters
        only): interchangeable with `DeviceScaleEngine` checkpoints in both
        directions.  A collective: every rank calls it."""
        return {"fleet": fleet_tree(self._gather(), self.task.layout),
                "times": self._scan_times[:self._C]}

    def restore_resumable(self, tree: dict, *, rounds: int,
                          energy: float) -> None:
        fleet = tree["fleet"]
        if not isinstance(fleet, FleetState):
            fleet = fleet_state_from_numpy(fleet, self.device)
        self.state = self._with_tables(self._permute(fleet))
        self._scan_times = torch.cat([
            torch.as_tensor(tree["times"], dtype=torch.float32).to(
                self.device),
            torch.full((self._C_pad - self._C,), float("inf"),
                       device=self.device)])
        self._rounds = int(rounds)
        self._energy_used = float(energy)
        sync_queue = getattr(self.controller, "sync_queue", None)
        if sync_queue is not None:
            sync_queue(self.state.queue)

    def obs_state_summary(self) -> dict:
        """The parent's gauges over the real devices (a collective)."""
        st = self._gather()
        vals = torch.stack([st.queue, st.rep.min(), st.rep.mean(),
                            st.rep.max(), st.twins.beta.sum()]).tolist()
        return dict(zip(("queue_deficit", "reputation_min",
                         "reputation_mean", "reputation_max",
                         "twin_beta_sum"), vals))

    @property
    def scan_times(self) -> torch.Tensor:
        return self._scan_times[:self._C]

    @property
    def rep(self) -> torch.Tensor:
        return self._gather().rep

    @property
    def twins(self) -> TwinState:
        return self._gather().twins

    @property
    def channel(self) -> torch.Tensor:
        return self._gather().channel

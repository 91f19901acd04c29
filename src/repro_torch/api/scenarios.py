"""Scenario presets and the named spec dicts the port is driven at on the
card.

The ten presets of the JAX package's ``repro.api.scenarios``, registered
under the same names in `SCENARIOS` (the CLI, ``python -m
repro_torch.api.run``, resolves from it).  ``adaptive-scanned-sharded``
(an 8-way fleet mesh) builds the cluster-major engine under an 8-rank
launch (`repro_torch.launch.distributed`); outside one, building it raises
the placement's `ValueError`.  ``lm-modeA`` runs the datacenter scale's
federated LM step.

The full-width spec dicts:

``PAPER_MLP_FLEET1K``: the paper's 784-200-10 MLP
(`repro/configs/paper_mnist.py`, §V) on a fleet of 1,024 devices in 16
clusters, 65,536 synthetic samples of width 784, trust aggregation and
Lyapunov control (budget 27,000 over a horizon of 60).  `chip_smoke.py`
and `scripts/port_profile.py` both build their federation from it.

``PAPER_ADAPTIVE_FLEET1K``: the same federation under the paper's full
scheme, a DQN pretrained on the DT environment picking each round's
local-step count (the controller of the JAX package's ``adaptive``
preset: 3 episodes of 20 steps).

``ANOMALY_FLEET1K``: the JAX package's ``autoencoder-anomaly`` task
(32-64-8-64-32 autoencoder on IoT telemetry of 8 device types, local
batch 32, lr 0.1) on the same fleet and sample count, under the
``adaptive`` preset's DQN, so the autoencoder's code mean feeds the DQN
observation.  The flat model is N = 5,288 floats.

``DP_FLEET1K``: ``PAPER_MLP_FLEET1K`` with the ``dp`` preset's client-level
differential privacy (clip 1.0, noise multiplier 0.5).

``FAULTY_FLEET1K``: ``PAPER_MLP_FLEET1K`` with the ``faulty-fleet``
preset's faults (dropout 0.15, stragglers 0.125, twin spikes 0.1, sign-flip
corruption of a quarter of the devices at scale 4), trust aggregation.

``FAULTY_MEDIAN_FLEET1K``: the same faults under the coordinate median.

``RECURRENTGEMMA_2B_TRAIN``: federated mode-A training of recurrentgemma-2b
at full width (`repro_torch/configs/recurrentgemma_2b.py`: d_model 2560,
10 query heads of 256 over one K/V head, LRU width 2560, d_ff 7680,
vocabulary 256,000, window 2048) cut to one Griffin period (num_layers 26
-> 3: RG-LRU, RG-LRU, local attention; 912,314,880 parameters), NC 2 x C 2
clients, 4096-token sequences, 2 microbatches of 1, a fixed a = 2 (the
``lm-modeA`` controller), Adam at 3e-4.  Four clients' parameters and Adam
moments are 40.8 GiB in float32; the full 26 layers would be 129 GiB.

``FALCON_MAMBA_7B_TRAIN``: the same federation and traffic (NC 2 x C 2
clients, 4096-token sequences, 2 microbatches of 1, a fixed a = 2, Adam at
3e-4) training falcon-mamba-7b at full width
(`repro_torch/configs/falcon_mamba_7b.py`: d_model 4096, d_inner 8192,
N 16, dt_rank 256, conv 4, vocabulary 65,024, tied embeddings; its own
``fl_mode``, ``fedavg_replica``) cut to 2 MAMBA layers (num_layers 64 ->
2), so that one layer's input gradient passes back through the layer
before it: 476,966,912 parameters (266,338,304 of embedding, 105,312,256 a
layer, the final norm).  Four clients' parameters and Adam moments are
21.3 GiB in float32; the full 64 layers would be ~313 GiB.

``DEEPSEEK_V2_236B_TRAIN``: federated mode-B training (its own ``fl_mode``,
``trust_fsdp``: trust as per-example loss weights, NC 2 cluster models) of
deepseek-v2-236b at full width (`repro_torch/configs/deepseek_v2_236b.py`:
d_model 5120, 128 heads, MLA with q_lora 1536, kv_lora 512, qk_nope 128,
qk_rope 64, v 128, dense d_ff 12288, moe_d_ff 1536, top-6, 2 shared
experts, vocabulary 102,400), with the same traffic (4096-token
sequences, 2 microbatches of 1, a fixed a = 2, Adam at 3e-4, seed 0).
Cut from 60 layers to 2 (the dense layer 0, then one MoE layer) and from
160 routed experts to 16, so that capacity is int(4096 * 6 * 1.25 // 16)
= 1920 slots an expert: 1,960,555,520 parameters (1,048,576,000 of
embedding and head, 149.2M of MLA a layer, the dense MLP 188.7M, 16
experts 377.5M, the shared experts 47.2M), 7.84 GB in float32.  Two
cluster models with Adam's m and v are six copies, 47.0 GB; with all 160
experts the two layers would be 5.4e9 parameters, ~129 GB in mode B.

``MUSICGEN_LARGE_TRAIN``: federated mode-A training (its own ``fl_mode``,
``fedavg_replica``) of musicgen-large at full width
(`repro_torch/configs/musicgen_large.py`: d_model 2048, 32 heads of 64
over 32 K/V heads, d_ff 8192, vocabulary 2048, 4 codebooks) with
``RECURRENTGEMMA_2B_TRAIN``'s clients and traffic (NC 2 x C 2, 4096
positions x 4 codebooks, 2 microbatches of 1, a fixed a = 2).  Cut from
48 layers to 4: 302,008,320 parameters (67.1M a layer, 33.6M of codebook
embeddings and heads); four clients' parameters and Adam moments are
14.5 GB in float32.
"""
from __future__ import annotations

from .registry import register_scenario
from .spec import (AggregatorSpec, ChannelSpec, ClusteringSpec,
                   ControllerSpec, DATACENTER_SCALE, FaultSpec,
                   FederationSpec, FleetSpec, PrivacySpec, ShardingSpec,
                   TaskSpec)

PAPER_MLP_FLEET1K = {
    "fleet": {"n_devices": 1024},
    "clustering": {"n_clusters": 16},
    "controller": {"kind": "lyapunov",
                   "params": {"budget": 27000, "horizon": 60}},
    "aggregator": {"kind": "trust"},
    "task": {"kind": "mlp", "params": {"n_samples": 65536, "dim": 784,
                                       "hidden": 200, "n_classes": 10}},
    "local_batch": 64, "lr": 0.1, "seed": 0,
}

# the JAX package's `adaptive` preset's controller
_ADAPTIVE_DQN = {"kind": "dqn", "params": {"episodes": 3, "horizon": 20}}

PAPER_ADAPTIVE_FLEET1K = {**PAPER_MLP_FLEET1K, "controller": _ADAPTIVE_DQN}

ANOMALY_FLEET1K = {
    "fleet": {"n_devices": 1024},
    "clustering": {"n_clusters": 16},
    "controller": _ADAPTIVE_DQN,
    "aggregator": {"kind": "trust"},
    "task": {"kind": "autoencoder-anomaly",
             "params": {"n_samples": 65536, "dim": 32, "n_types": 8,
                        "latent": 4, "anomaly_frac": 0.05, "noise": 0.05,
                        "hidden": 64, "code": 8}},
    "local_batch": 32, "lr": 0.1, "seed": 0,
}

# the `dp` preset's privacy and the `faulty-fleet` preset's faults
_DP = {"clip": 1.0, "noise": 0.5}
_FAULTY = {"dropout": 0.15, "straggler_frac": 0.125, "twin_spike_prob": 0.1,
           "corrupt_mode": "sign_flip", "corrupt_frac": 0.25,
           "corrupt_scale": 4.0}

DP_FLEET1K = {**PAPER_MLP_FLEET1K, "privacy": _DP}

FAULTY_FLEET1K = {**PAPER_MLP_FLEET1K, "faults": _FAULTY}

FAULTY_MEDIAN_FLEET1K = {**FAULTY_FLEET1K,
                         "aggregator": {"kind": "median"}}


_RG2B = {"num_layers": 3, "name": "recurrentgemma-2b-train",
         "arch_type": "hybrid", "d_model": 2560, "vocab_size": 256000,
         "num_heads": 10, "num_kv_heads": 1, "head_dim": 256, "d_ff": 7680,
         "activation": "gelu", "block_pattern": ["rglru", "rglru", "local"],
         "window": 2048, "lru_width": 2560, "ssm_conv": 4,
         "emb_scale": True, "tie_embeddings": True,
         "fl_mode": "fedavg_replica"}

RECURRENTGEMMA_2B_TRAIN = {
    "scale": DATACENTER_SCALE,
    "fleet": {"n_devices": 4},
    "clustering": {"n_clusters": 2},
    "controller": {"kind": "fixed", "params": {"a": 2, "n_actions": 4}},
    "task": {"kind": "lm",
             "params": {**_RG2B, "seq": 4096, "micro_batch": 1,
                        "n_micro": 2, "lr": 3e-4}},
    "rounds": 3, "seed": 0,
}

_FM7B = {"num_layers": 2, "name": "falcon-mamba-7b-train",
         "arch_type": "ssm", "d_model": 4096, "vocab_size": 65024,
         "d_ff": 0, "block_pattern": ["mamba"], "ssm_state": 16,
         "ssm_expand": 2, "ssm_conv": 4, "dt_rank": 256,
         "tie_embeddings": True, "fl_mode": "fedavg_replica"}

FALCON_MAMBA_7B_TRAIN = {
    **RECURRENTGEMMA_2B_TRAIN,
    "task": {"kind": "lm",
             "params": {**_FM7B, "seq": 4096, "micro_batch": 1,
                        "n_micro": 2, "lr": 3e-4}},
}

_DSV2 = {"num_layers": 2, "name": "deepseek-v2-236b-train",
         "arch_type": "moe", "d_model": 5120, "vocab_size": 102400,
         "num_heads": 128, "num_kv_heads": 128, "d_ff": 12288,
         "num_experts": 16, "num_shared_experts": 2, "topk": 6,
         "moe_d_ff": 1536, "first_dense_layers": 1, "use_mla": True,
         "q_lora_rank": 1536, "kv_lora_rank": 512, "qk_nope_dim": 128,
         "qk_rope_dim": 64, "v_head_dim": 128, "mla_absorbed": True,
         "activation": "silu", "tie_embeddings": False,
         "fl_mode": "trust_fsdp", "shard_scheme": "ep_tp",
         "scan_indexed": True}

DEEPSEEK_V2_236B_TRAIN = {
    **RECURRENTGEMMA_2B_TRAIN,
    "task": {"kind": "lm",
             "params": {**_DSV2, "mode": "trust_fsdp", "seq": 4096,
                        "micro_batch": 1, "n_micro": 2, "lr": 3e-4}},
}

_MUSICGEN = {"num_layers": 4, "name": "musicgen-large-train",
             "arch_type": "audio", "d_model": 2048, "vocab_size": 2048,
             "num_heads": 32, "num_kv_heads": 32, "head_dim": 64,
             "d_ff": 8192, "activation": "gelu", "num_codebooks": 4,
             "tie_embeddings": False, "fl_mode": "fedavg_replica"}

MUSICGEN_LARGE_TRAIN = {
    **RECURRENTGEMMA_2B_TRAIN,
    "task": {"kind": "lm",
             "params": {**_MUSICGEN, "seq": 4096, "micro_batch": 1,
                        "n_micro": 2, "lr": 3e-4}},
}


@register_scenario("sync-baseline")
def _sync_baseline() -> FederationSpec:
    """Benchmark scheme: synchronous FedAvg, one cluster, fixed a=5."""
    return FederationSpec(
        clustering=ClusteringSpec(n_clusters=1),
        controller=ControllerSpec("fixed", {"a": 5}),
        aggregator=AggregatorSpec("fedavg"),
        sim_seconds=15.0)


@register_scenario("byzantine")
def _byzantine() -> FederationSpec:
    """25% label-flipping clients; trust aggregation must down-weight them."""
    return FederationSpec(
        fleet=FleetSpec(n_devices=16, malicious_frac=0.25),
        controller=ControllerSpec("fixed", {"a": 5}),
        aggregator=AggregatorSpec("trust"),
        sim_seconds=15.0)


@register_scenario("faulty-fleet")
def _faulty_fleet() -> FederationSpec:
    """Fault injection inside the round: device dropout, stragglers,
    twin-deviation spikes, and sign-flip Byzantine corruption, with trust
    aggregation absorbing the damage (`repro_torch.faults`)."""
    return FederationSpec(
        fleet=FleetSpec(n_devices=16),
        clustering=ClusteringSpec(n_clusters=2),
        controller=ControllerSpec("fixed", {"a": 5}),
        aggregator=AggregatorSpec("trust"),
        faults=FaultSpec(**_FAULTY),
        execution="scanned", rounds=30, sim_seconds=1e9)


@register_scenario("dp")
def _dp() -> FederationSpec:
    """Client-level DP on top of trust aggregation."""
    return FederationSpec(
        controller=ControllerSpec("fixed", {"a": 5}),
        privacy=PrivacySpec(**_DP),
        sim_seconds=15.0)


@register_scenario("heterogeneous")
def _heterogeneous() -> FederationSpec:
    """Wide DT deviation + bad channel; Lyapunov-greedy frequency control."""
    return FederationSpec(
        fleet=FleetSpec(n_devices=16, dt_max_dev=0.4),
        channel=ChannelSpec(p_good=0.3),
        controller=ControllerSpec("lyapunov",
                                  {"budget": 150.0, "horizon": 60}),
        sim_seconds=15.0)


@register_scenario("adaptive")
def _adaptive() -> FederationSpec:
    """The paper's full scheme: DQN trained on the DT env picks a_i."""
    return FederationSpec(
        controller=ControllerSpec("dqn", {"episodes": 3, "horizon": 20}),
        sim_seconds=15.0)


@register_scenario("adaptive-scanned")
def _adaptive_scanned() -> FederationSpec:
    """Full scheme with the controller on the card: DQN pretrain on the
    device, then K scanned rounds."""
    return FederationSpec(
        controller=ControllerSpec("dqn", {"episodes": 3, "horizon": 20}),
        execution="scanned", rounds=40, sim_seconds=15.0)


@register_scenario("adaptive-scanned-sharded")
def _adaptive_scanned_sharded() -> FederationSpec:
    """Scanned full scheme on an 8-way fleet mesh: 8 ranks, one shard
    each (API.md "Placement")."""
    return FederationSpec(
        fleet=FleetSpec(n_devices=16),
        controller=ControllerSpec("dqn", {"episodes": 3, "horizon": 20}),
        execution="scanned", rounds=40, sim_seconds=15.0,
        sharding=ShardingSpec(mesh=(8,)))


@register_scenario("autoencoder-anomaly")
def _autoencoder_anomaly() -> FederationSpec:
    """Federated autoencoder anomaly detection on non-IID IoT telemetry
    (reconstruction loss; trace ``acc`` is the detection AUC), scanned
    under Lyapunov frequency control."""
    return FederationSpec(
        fleet=FleetSpec(n_devices=16),
        clustering=ClusteringSpec(n_clusters=4),
        controller=ControllerSpec("lyapunov",
                                  {"budget": 1600.0, "horizon": 100}),
        aggregator=AggregatorSpec("trust"),
        task=TaskSpec("autoencoder-anomaly",
                      {"n_samples": 2048, "dim": 32, "n_types": 8,
                       "hidden": 64, "code": 8}),
        execution="scanned", rounds=25, sim_seconds=1e9,
        local_batch=32, lr=0.1)


@register_scenario("lm-modeA")
def _lm_mode_a() -> FederationSpec:
    """Datacenter scale: tiny-LM FedAvg-replica."""
    return FederationSpec(
        scale=DATACENTER_SCALE,
        fleet=FleetSpec(n_devices=8),
        clustering=ClusteringSpec(n_clusters=2),
        controller=ControllerSpec("fixed", {"a": 2, "n_actions": 4}),
        task=TaskSpec("lm", {"seq": 16, "micro_batch": 2}),
        rounds=5)

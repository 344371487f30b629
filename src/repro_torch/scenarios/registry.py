"""Named robustness scenarios — the port of
``repro/scenarios/registry.py``: one ``Scenario`` is one cell of the
attack x heterogeneity x compression x aggregator grid.

The cells, their names and their fields are the JAX package's, so the two
robustness matrices line up row for row: the curated ``SCENARIOS`` and
``smoke_grid()``'s {gate_aware, alie, none} x {trimmed_mean, krum,
fedavg} x {dropout on/off} plus four buffered-async cells.  Every cell
runs by name through ``engine.run_scenario``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple

from repro_torch.configs.base import FedConfig
from repro_torch.core.faults import FaultConfig

DATA_ATTACKS = ("label_flip", "backdoor")
UPDATE_ATTACKS = ("sign_flip", "gaussian", "scale",
                  "alie", "min_max", "min_sum", "gate_aware",
                  "cross_round")
ATTACKS = ("none",) + DATA_ATTACKS + UPDATE_ATTACKS


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str = ""
    attack: str = "none"              # one of ATTACKS
    mal_frac: float = 0.3             # paper-style 30% byzantine
    aggregator: str = "trimmed_mean"  # fedavg|median|trimmed_mean|krum
    algorithm: str = "fedavg"         # selection algorithm; the attack x
                                      # aggregator cells default to full
                                      # participation so the matrix
                                      # isolates AGGREGATION robustness
                                      # (a fitness election that shrinks
                                      # the cohort below ~2*colluders
                                      # un-sizes any trimmed defense —
                                      # that interaction gets its own
                                      # fedfits cells)
    compress: str = "none"            # uplink codec (comm/codecs.py)
    faults: FaultConfig = field(default_factory=FaultConfig)
    backdoor_target: int = 0
    backdoor_patch: int = 3
    attack_scale: float = 10.0        # sign_flip / scale_attack boost
    alie_z: float = 4.0               # ALIE deviation (None -> the paper's
                                      # median-evasion prescription, which
                                      # is tuned for median defenses and
                                      # near-invisible to plain fedavg)
    # buffered-async cells (core/async_engine.py)
    async_mode: bool = False          # route through the async engine:
                                      # cohort of n_clients SAMPLED from a
                                      # population-scale ClientStore, late
                                      # deliveries retried via the buffer
    population: int = 0               # registered clients M (0 -> engine
                                      # default of 3x the cohort)
    straggler_rows: str = "tail"      # chronic-straggler placement; "head"
                                      # makes the malicious rows (always
                                      # the first ones) the stragglers —
                                      # the late-poison evasion channel
    fed: Tuple[Tuple[str, object], ...] = ()  # extra FedConfig overrides

    def fed_config(self, n_clients: int) -> FedConfig:
        """Defense sized to the declared threat model: trim_frac and
        krum_f cover ``mal_frac`` colluders (a trimmed mean that trims
        fewer rows per side than there are colluders, or a Krum scoring
        window that counts colluder-to-colluder zeros, is a
        misconfiguration, not a defense)."""
        n_mal = max(int(round(self.mal_frac * n_clients)), 1)
        kw = dict(trim_frac=max(0.2, self.mal_frac),
                  krum_f=n_mal, **dict(self.fed))
        return FedConfig(n_clients=n_clients, algorithm=self.algorithm,
                         aggregator=self.aggregator, compress=self.compress,
                         local_epochs=2, local_lr=0.2, **kw)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


_DROPOUT = FaultConfig(dropout_prob=0.3)
_HETERO = FaultConfig(straggler_frac=0.25, straggler_delay=3.0,
                      partial_min_frac=0.5)
# async cells: 30% chronic stragglers racing the round deadline, everyone
# else mildly delayed — the graceful-degradation regime
_LATE = FaultConfig(straggler_frac=0.3, straggler_delay=3.0,
                    base_delay=0.3)

SCENARIOS: Dict[str, Scenario] = {s.name: s for s in [
    # ---- baselines --------------------------------------------------
    Scenario("clean_fedavg", "no attack, plain mean",
             attack="none", aggregator="fedavg"),
    Scenario("clean_trimmed", "no attack, trimmed-mean defense"),
    # ---- adaptive attackers vs the aggregator zoo -------------------
    Scenario("alie_fedavg", "ALIE colluders vs undefended mean",
             attack="alie", aggregator="fedavg"),
    Scenario("alie_trimmed", "ALIE vs trimmed mean", attack="alie"),
    Scenario("alie_krum", "ALIE vs Krum", attack="alie",
             aggregator="krum"),
    Scenario("gate_aware_fedavg", "defense-aware attacker vs plain mean",
             attack="gate_aware", aggregator="fedavg"),
    Scenario("gate_aware_trimmed", "defense-aware attacker vs its own "
             "defense", attack="gate_aware"),
    Scenario("gate_aware_krum", "defense-aware attacker vs Krum",
             attack="gate_aware", aggregator="krum"),
    Scenario("minmax_trimmed", "min-max distance attack vs trimmed mean",
             attack="min_max"),
    Scenario("minsum_trimmed", "min-sum distance attack vs trimmed mean",
             attack="min_sum"),
    # ---- targeted / static -----------------------------------------
    Scenario("backdoor_trimmed", "corner-trigger backdoor (trigger-"
             "accuracy tracked per round)", attack="backdoor"),
    Scenario("signflip_trimmed", "10x sign-flip vs trimmed mean",
             attack="sign_flip"),
    # ---- system heterogeneity ---------------------------------------
    Scenario("dropout_trimmed", "30% mid-round update loss, clean",
             faults=_DROPOUT),
    Scenario("hetero_fedfits", "chronic stragglers + partial local work "
             "under the fitness election", algorithm="fedfits",
             faults=_HETERO),
    # ---- selection-dynamics cells (fitness election under attack) ----
    Scenario("alie_fedfits", "ALIE vs the fitness election + trimmed "
             "mean (the cohort-shrinking interaction)",
             attack="alie", algorithm="fedfits"),
    Scenario("signflip_fedfits", "sign-flip vs the fitness election "
             "(gate_trust EWMA demotes gated clients)",
             attack="sign_flip", algorithm="fedfits"),
    # ---- compression cells (incl. the dropout+compression cell) -----
    Scenario("signflip_trimmed_int8", "sign-flip under the int8 uplink",
             attack="sign_flip", compress="int8"),
    Scenario("gate_aware_int8_dropout", "defense-aware attacker + int8 "
             "uplink + mid-round dropout", attack="gate_aware",
             compress="int8", faults=_DROPOUT),
    # ---- cross-round adaptive attacker (stateful) -------------------
    Scenario("cross_round_trimmed", "stateful attacker probing the gate "
             "across rounds (blend re-tuned from last round's gate "
             "outcome) vs trimmed mean", attack="cross_round"),
    # ---- buffered-async cells (population-scale ClientStore) ---------
    Scenario("async_hetero", "buffered-async engine, 30% chronic "
             "stragglers retried through the staleness-weighted buffer, "
             "clean", async_mode=True, faults=_LATE),
    Scenario("async_late_poison", "the colluders ARE the chronic "
             "stragglers (straggler_rows=head): their cross-round poison "
             "arrives LATE through the retry buffer at stale weight and "
             "must not evade the threat-sized trimmed mean",
             async_mode=True, attack="cross_round",
             straggler_rows="head", faults=_LATE),
    Scenario("async_late_poison_krum", "late-arriving stale-weight "
             "poison vs threat-sized Krum", async_mode=True,
             attack="cross_round", aggregator="krum",
             straggler_rows="head", faults=_LATE),
]}


def smoke_grid() -> Dict[str, Scenario]:
    """CI smoke matrix: {gate_aware, alie, none} x {trimmed_mean, krum,
    fedavg} x {dropout on/off} -> 18 cells named grid/<a>+<agg>[+drop],
    plus 4 buffered-async cells (async/<a>+<agg>) running the
    population-scale engine under 30% chronic stragglers."""
    cells = {}
    for atk in ("gate_aware", "alie", "none"):
        for agg in ("trimmed_mean", "krum", "fedavg"):
            for drop in (False, True):
                name = f"grid/{atk}+{agg}" + ("+drop" if drop else "")
                cells[name] = Scenario(
                    name, "CI smoke-grid cell", attack=atk, aggregator=agg,
                    faults=_DROPOUT if drop else FaultConfig())
    for atk, agg in (("none", "trimmed_mean"), ("none", "fedavg"),
                     ("sign_flip", "trimmed_mean"),
                     ("cross_round", "trimmed_mean")):
        name = f"async/{atk}+{agg}"
        cells[name] = Scenario(
            name, "CI async smoke cell", attack=atk, aggregator=agg,
            async_mode=True, faults=_LATE,
            straggler_rows="head" if atk != "none" else "tail")
    return cells


def all_scenarios() -> Dict[str, Scenario]:
    return {**SCENARIOS, **smoke_grid()}


def get(name: str) -> Scenario:
    table = all_scenarios()
    if name not in table:
        known = ", ".join(sorted(table))
        raise KeyError(f"unknown scenario {name!r}; known: {known}")
    return table[name]

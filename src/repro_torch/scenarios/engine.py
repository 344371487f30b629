"""Turns one registry ``Scenario`` into a run of the port's round engines
and a robustness/fairness summary row — the port of
``repro/scenarios/engine.py``.

Attacks bind to the rounds through their ``data_attack`` /
``update_attack`` hooks (``core/attacks.py``'s protocol), faults through
the ``faults`` FaultConfig, so a scenario runs the same code path as
every other run.  Backdoor trigger accuracy is tracked every round for
every cell: the trigger-stamped server test set scored against the
backdoor target class (for a cell without a backdoor it stays at the
target class's base rate).

Runs on the card unless ``device="cpu"``, through the engines' chunked
driver (``driver="scan"``, ``chunk_rounds`` rounds a chunk, as in the JAX
package) or their per-round loop (``driver="python"``).  Telemetry is on
by default, as in the JAX package: every cell runs with a
``Telemetry(sinks=[MemorySink()])``, so every history row carries the
``obs/`` keys and the summary ``obs_rows``, ``obs_warnings`` and
``obs_warning_counts``; ``telemetry=False`` runs the telemetry-free
program.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.configs.paper_models import CNN_CONFIG, MLP_CONFIG
from repro_torch.core import async_engine, attacks, fedfits
from repro_torch.data.pipeline import build_federation
from repro_torch.models.model import build
from repro_torch.obs import MemorySink, Telemetry
from repro_torch.scenarios import registry

ARCHS = {c.name: c for c in (CNN_CONFIG, MLP_CONFIG)}


def make_attack_fns(sc, fed_cfg, n_classes):
    """(data_attack, update_attack) callables for one scenario cell."""
    data_attack = update_attack = None
    a = sc.attack
    if a == "label_flip":
        def data_attack(data, mal, noise):
            return {"y": attacks.label_flip(data["y"], n_classes, mal)}
    elif a == "backdoor":
        def data_attack(data, mal, noise):
            x, y = attacks.backdoor_trigger(
                data["x"], data["y"], mal, target=sc.backdoor_target,
                patch=sc.backdoor_patch)
            return {"x": x, "y": y}
    elif a == "sign_flip":
        def update_attack(upd, mal, noise):
            return attacks.sign_flip(upd, mal, scale=sc.attack_scale)
    elif a == "gaussian":
        def update_attack(upd, mal, noise):
            return attacks.gaussian_update(upd, mal, sc.attack_scale, noise)
        update_attack.draws_noise = True
    elif a == "scale":
        def update_attack(upd, mal, noise):
            return attacks.scale_attack(upd, mal, sc.attack_scale)
    elif a == "alie":
        def update_attack(upd, mal, noise):
            return attacks.alie(upd, mal, z=sc.alie_z)
    elif a in ("min_max", "min_sum"):
        fn = getattr(attacks, a)

        def update_attack(upd, mal, noise):
            return fn(upd, mal)
    elif a == "gate_aware":
        def update_attack(upd, mal, noise):
            return attacks.gate_aware(upd, mal, fed_cfg)
    elif a == "cross_round":
        # stateful: the engines carry its (blend, prev_gated) state
        update_attack = attacks.CrossRoundGateAware(fed_cfg)
    elif a != "none":
        raise ValueError(f"unknown attack {a!r}")
    return data_attack, update_attack


@dataclasses.dataclass
class Setup:
    """One cell, ready to run: the scenario (with any async override), its
    config (``population`` set for an async cell), the model, the
    population size, the malicious rows (the first ``n_mal``; None when
    the cell has no attacker) and the attack callables."""
    scenario: Any
    fed_cfg: Any
    model: Any
    population: int
    n_mal: int
    malicious: Optional[torch.Tensor]
    data_attack: Optional[Callable]
    update_attack: Optional[Callable]

    def eval_fn(self, server_test):
        """eval_fn(params) -> {test_acc, trigger_acc} on ``server_test``
        and on its trigger-stamped copy scored against the backdoor
        target."""
        sc, model = self.scenario, self.model
        trig = {"x": attacks.stamp_trigger(server_test["x"],
                                           patch=sc.backdoor_patch),
                "y": server_test["y"]}

        def eval_fn(params):
            _, m = model.loss(params, server_test)
            logits = model.forward(params, trig)
            hit = (logits.argmax(-1) == sc.backdoor_target).float().mean()
            return {"test_acc": m["acc"], "trigger_acc": hit}

        return eval_fn


def setup(scenario, *, n_clients=10, n_classes=10, kind="tabular", arch=None,
          population=None, async_deadline=None, device=None):
    """The setup half of ``run_scenario``: resolves the cell, its config,
    model, malicious rows and attack callables.  ``population`` /
    ``async_deadline`` force the cell through the buffered-async engine,
    as in the JAX package."""
    sc = registry.get(scenario) if isinstance(scenario, str) else scenario
    if (population or async_deadline) and sc.compress != "none":
        raise ValueError(
            f"scenario {sc.name!r} uses compress={sc.compress!r}, which the "
            "buffered-async engine does not support; drop population / "
            "async_deadline or pick a dense-uplink scenario")
    if population or async_deadline:
        sc = sc.replace(
            async_mode=True, population=population or sc.population,
            fed=sc.fed + ((("async_deadline", float(async_deadline)),)
                          if async_deadline else ()))
    fed_cfg = sc.fed_config(n_clients)
    pop = (sc.population or 3 * n_clients) if sc.async_mode else n_clients
    if sc.async_mode:
        fed_cfg = dataclasses.replace(fed_cfg, population=pop)
    model = build(ARCHS[arch or
                        ("paper-cnn" if kind == "images" else "paper-mlp")])
    n_mal = max(int(round(sc.mal_frac * pop)), 1) \
        if sc.attack != "none" else 0
    dev = device_mod.resolve(device)
    malicious = (torch.arange(pop, device=dev) < n_mal).float() \
        if n_mal else None
    data_attack, update_attack = make_attack_fns(sc, fed_cfg, n_classes)
    return Setup(sc, fed_cfg, model, pop, n_mal, malicious, data_attack,
                 update_attack)


def run_scenario(scenario, *, n_clients=10, n_rounds=10, seed=0,
                 kind="tabular", n=1600, n_classes=10, sep=1.0,
                 dirichlet_alpha=1.0, arch=None, driver="scan",
                 chunk_rounds=4, population=None, async_deadline=None,
                 telemetry=None, device=None):
    """Runs one scenario cell; returns (summary dict, per-round history).

    ``n_clients`` is the cohort: an async cell samples it each round from
    a population of ``sc.population`` (default 3 x the cohort) registered
    clients.  ``sep`` and ``dirichlet_alpha`` default to the JAX package's
    (a harder class separation than the pipeline's and a milder label
    skew, so the attacks have room to show).  The seed gives the data and
    the malicious rows; the run's generators are seeded ``seed + 1``.
    ``driver`` and ``chunk_rounds`` go to the engine.  ``telemetry``: an
    ``obs.Telemetry``; None (the default) gives the cell one with a
    ``MemorySink``, False none."""
    s = setup(scenario, n_clients=n_clients, n_classes=n_classes, kind=kind,
              arch=arch, population=population, async_deadline=async_deadline,
              device=device)
    sc = s.scenario
    federation, server_test = build_federation(
        seed, kind=kind, n=n, n_clients=s.population, batch_size=32,
        n_classes=n_classes, sep=sep, dirichlet_alpha=dirichlet_alpha,
        device=device)
    eval_fn = s.eval_fn(server_test)
    if telemetry is None:
        telemetry = Telemetry(sinks=[MemorySink()], run_name=sc.name)
    elif telemetry is False:
        telemetry = None
    t0 = time.perf_counter()
    if sc.async_mode:
        state, hist = async_engine.run_async(
            s.model, s.fed_cfg, federation.data, n_rounds, seed + 1,
            eval_fn=eval_fn, batch_size=federation.batch_size,
            eval_batch=federation.eval_batch, device=device,
            data_attack=s.data_attack, update_attack=s.update_attack,
            malicious=s.malicious, faults=sc.faults,
            straggler_rows=sc.straggler_rows, driver=driver,
            chunk_rounds=chunk_rounds, telemetry=telemetry)
    else:
        state, hist = fedfits.run(
            s.model, s.fed_cfg, federation.data_fn, n_rounds, seed + 1,
            eval_fn=eval_fn, device=device, data_attack=s.data_attack,
            update_attack=s.update_attack, malicious=s.malicious,
            faults=sc.faults, driver=driver, chunk_rounds=chunk_rounds,
            telemetry=telemetry)
    summary = summarize(sc, state, hist, s.n_mal, time.perf_counter() - t0)
    if telemetry is not None:
        obs = telemetry.finish()
        summary["obs_rows"] = obs["rows"]
        summary["obs_warnings"] = obs["n_warnings"]
        summary["obs_warning_counts"] = obs["warnings"]
    return summary, hist


def summarize(sc, state, hist, n_mal, wall_s):
    """One robustness/* row: accuracy, trigger accuracy, fairness, trust
    separation and cost of a finished scenario run."""
    accs = [float(h["test_acc"]) for h in hist]
    trig = [float(h["trigger_acc"]) for h in hist]
    last = hist[-1]
    gt = state.gate_trust.float().cpu()
    mal_mask = torch.arange(gt.shape[0]) < n_mal
    return {
        "name": f"robustness/{sc.name}",
        "attack": sc.attack, "aggregator": sc.aggregator,
        "algorithm": sc.algorithm, "compress": sc.compress,
        "faults_active": sc.faults.active, "n_malicious": n_mal,
        "rounds": len(hist),
        "final_acc": accs[-1], "best_acc": max(accs),
        "final_trigger_acc": trig[-1], "max_trigger_acc": max(trig),
        "fair_acc_var": float(last["fair_acc_var"]),
        "fair_worst_decile": float(last["fair_worst_decile"]),
        "fair_part_gini": float(last["fair_part_gini"]),
        "gated_frac_mean": float(torch.tensor(
            [float(h["gated_frac"]) for h in hist]).mean()),
        "gate_trust_malicious": (
            float(torch.where(mal_mask, gt, 0.0).sum() / n_mal)
            if n_mal else None),
        "gate_trust_honest": float(torch.where(mal_mask, 0.0, gt).sum()
                                   / max(gt.shape[0] - n_mal, 1)),
        "cost_client_rounds": float(state.cost_client_rounds),
        "cost_bytes_up": float(state.cost_bytes_up),
        "wall_s": round(wall_s, 2),
    }

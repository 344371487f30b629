"""Scenario engine (port of ``repro/scenarios/``): the named attack x
heterogeneity x compression x aggregator cells and the runner that turns
one cell into a robustness/fairness row.

  registry.get(name) / registry.all_scenarios()   the grid
  engine.run_scenario(name_or_scenario, ...)      one cell -> summary
"""
from repro_torch.scenarios.engine import run_scenario, summarize  # noqa: F401
from repro_torch.scenarios.registry import (SCENARIOS, Scenario,  # noqa: F401
                                            all_scenarios, get, smoke_grid)

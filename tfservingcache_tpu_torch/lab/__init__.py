"""Scenario lab (counterpart of ``tfservingcache_tpu/lab``): composable
workload specs, a fault injector, and SLO scorecards over the port's
serving machinery.

* ``workload`` — a declarative DSL (tenant mix x zipf skew x arrival
  process x prompt-length mix x multi-turn depth) compiled to a seeded,
  replayable request schedule;
* ``faults`` — a process-global injector with hook sites in the engine, the
  cache manager, the peer-transfer receiver and the fleet status plane;
  disarmed (the default) every hook is a passthrough, armed only through
  ``observability.lab_faults`` or an explicit ``arm()``;
* ``scenario`` — runs one scenario x fault cell end to end and emits an SLO
  scorecard row.

This ``__init__`` imports nothing: serving modules import ``lab.faults``
for their hook sites, and that must not pull the DSL into a node's import
graph.
"""

"""Discrete-event cluster simulator: the faithful reproduction substrate for
the paper's framework comparisons (Pollen vs Flower/FedScale/Flute/Parrot)."""

from repro_torch.simcluster.engine import (RoundStats, Worker, client_time,
                                     make_workers, simulate_pull_round,
                                     simulate_push_round)
from repro_torch.simcluster.frameworks import (FRAMEWORKS, ExperimentResult,
                                         run_experiment)
from repro_torch.simcluster.profiles import (GPUS, TASKS, ClusterSpec, multi_node,
                                       single_node)

__all__ = ["RoundStats", "Worker", "client_time", "make_workers",
           "simulate_pull_round", "simulate_push_round", "FRAMEWORKS",
           "ExperimentResult", "run_experiment", "GPUS", "TASKS",
           "ClusterSpec", "multi_node", "single_node"]

"""Shared small configuration for the PyTorch port's parity tests: one SR
setup (``width=64, n_blocks=2``; cohort 4 over 2 workers x 2 lanes,
``steps_cap`` 4) built for the JAX reference and for the port from the same
numpy inputs."""

import jax
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import FederatedEngine as JEngine
from repro.core import SyntheticTelemetry as JTelemetry
from repro.core import UniformSampler as JSampler
from repro.core import make_placement as jplacement
from repro.core.placement import ClientInfo, RoundRobinPlacement
from repro.data import make_federated_dataset
from repro.data.batching import build_round_arrays
from repro.distributed import WorkerPool as JPool
from repro.models.papertasks import make_task_model
from repro.optim import sgd as jsgd
from repro_torch.core import EngineConfig as TConfig
from repro_torch.core import FederatedEngine as TEngine
from repro_torch.core import SyntheticTelemetry as TTelemetry
from repro_torch.core import UniformSampler as TSampler
from repro_torch.core import make_placement as tplacement
from repro_torch.distributed import WorkerPool as TPool
from repro_torch.models.papertasks import TASK_MODELS
from repro_torch.optim import sgd as tsgd

SEED = 1337
LR, MOMENTUM, WD = 0.05, 0.9, 5e-4
COHORT, WORKERS, LANES, STEPS_CAP, BATCH = 4, 2, 2, 4, 4


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread at these tiny shapes: torch's pool would only
    fight XLA's (and the other test processes') for the cores.  Import it
    into a test module to apply it there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_dataset():
    """The reference's SR dataset, small: 64 clients of a few batches."""
    return make_federated_dataset("sr", n_clients=64, batch_size=BATCH,
                                  size_mu=2.5, size_sigma=0.8, seed=SEED)


def ref_params(seed=0):
    """Reference SR weights (jax.random init) as numpy."""
    p, _ = make_task_model("sr", jax.random.key(seed), width=64, n_blocks=2)
    return {k: np.asarray(v) for k, v in p.items()}


def ref_round_arrays(ds, cids=(0, 1, 2, 3)):
    """The reference packer's RoundArrays for a round-robin placement."""
    workers = JPool.homogeneous(WORKERS, type_name="a40",
                                concurrency=LANES).snapshot()
    clients = [ClientInfo(cid=c, n_batches=ds.n_batches(c),
                          n_samples=ds.n_samples(c)) for c in cids]
    asg = RoundRobinPlacement().assign(clients, workers)
    return build_round_arrays(ds, asg, workers, lanes_per_worker=LANES,
                              steps_cap=STEPS_CAP, batch_size=BATCH)


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


def ref_engine(ds, params, *, agg_impl="xla", depth=1, deadline_rho=0.0):
    _, loss = make_task_model("sr", jax.random.key(0), width=64, n_blocks=2)
    return JEngine(
        dataset=ds, loss_fn=loss,
        init_params=jax.tree.map(jax.numpy.asarray, params),
        optimizer=jsgd(LR, momentum=MOMENTUM, weight_decay=WD),
        placement=jplacement("lb"), sampler=JSampler(ds.n_clients, COHORT,
                                                     seed=SEED),
        pool=JPool.homogeneous(WORKERS, type_name="a40", concurrency=LANES),
        telemetry=JTelemetry(seed=SEED),
        config=JConfig(steps_cap=STEPS_CAP, batch_size=BATCH, seed=SEED,
                       lanes_per_worker=LANES, pipeline_depth=depth,
                       agg_impl=agg_impl, deadline_rho=deadline_rho))


def port_engine(ds, params, *, agg_impl="kernel", depth=1, deadline_rho=0.0,
                obs=None):
    return TEngine(
        dataset=ds, loss_fn=TASK_MODELS["sr"].loss_fn, init_params=params,
        optimizer=tsgd(LR, momentum=MOMENTUM, weight_decay=WD),
        placement=tplacement("lb"), sampler=TSampler(ds.n_clients, COHORT,
                                                     seed=SEED),
        pool=TPool.homogeneous(WORKERS, type_name="a40", concurrency=LANES),
        telemetry=TTelemetry(seed=SEED),
        config=TConfig(steps_cap=STEPS_CAP, batch_size=BATCH,
                       lanes_per_worker=LANES, pipeline_depth=depth,
                       agg_impl=agg_impl, deadline_rho=deadline_rho),
        obs=obs, device="cpu")

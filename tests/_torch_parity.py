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


# -- the reference's system-test engine (tests/test_system.py:19-43) ---------
SYS_MODEL = dict(input_dim=16, width=32, n_blocks=2)


def system_dataset():
    """The reference's dataset of its system tests: 64 SR clients."""
    return make_federated_dataset("sr", n_clients=64, input_dim=16,
                                  batch_size=4, size_mu=2.5, size_sigma=0.8)


def system_params():
    p, _ = make_task_model("sr", jax.random.key(0), **SYS_MODEL)
    return {k: np.asarray(v) for k, v in p.items()}


def system_engine(port: bool, *, strategy="fedavg", depth=1, ckpt=None,
                  rounds_per_ckpt=2, specs=None, workers=2, dataset=None,
                  sampler=None, obs=None, **cfg):
    """``tests/test_system.py``'s ``_small_engine`` (cohort 8 over 2
    workers x 2 lanes, ``steps_cap`` 4, SGD lr 0.1 momentum 0.9, LB) for
    the reference (``port=False``) or the port on the CPU, both on the
    reference's dataset and weights.  ``ckpt`` is a checkpoint directory;
    ``specs`` a worker pool's specs; ``dataset`` and ``sampler`` replace
    the 64-client dataset and its uniform sampler; ``obs`` is an
    observability bundle of the engine's package; ``cfg`` more config
    fields."""
    from repro.checkpoint import CheckpointStore as JStore
    from repro.fl.strategy import strategy_from_name as jstrategy
    from repro_torch.checkpoint import CheckpointStore as TStore
    from repro_torch.fl.strategy import strategy_from_name as tstrategy
    ds = system_dataset() if dataset is None else dataset
    params = system_params()
    if port:
        pool = (TPool.from_specs(specs) if specs else
                TPool.homogeneous(workers, type_name="a40", concurrency=2))
        return TEngine(
            dataset=ds, loss_fn=TASK_MODELS["sr"].loss_fn,
            init_params=to_torch(params), optimizer=tsgd(0.1, momentum=0.9),
            placement=tplacement("lb"),
            sampler=TSampler(64, 8) if sampler is None else sampler,
            pool=pool, telemetry=TTelemetry(), strategy=tstrategy(strategy),
            config=TConfig(steps_cap=4, batch_size=4, lanes_per_worker=2,
                           pipeline_depth=depth,
                           rounds_per_checkpoint=rounds_per_ckpt, **cfg),
            checkpoint_store=TStore(str(ckpt)) if ckpt else None,
            obs=obs, device="cpu")
    _, loss = make_task_model("sr", jax.random.key(0), **SYS_MODEL)
    pool = (JPool.from_specs(specs) if specs else
            JPool.homogeneous(workers, type_name="a40", concurrency=2))
    return JEngine(
        dataset=ds, loss_fn=loss,
        init_params=jax.tree.map(jax.numpy.asarray, params),
        optimizer=jsgd(0.1, momentum=0.9), placement=jplacement("lb"),
        sampler=JSampler(64, 8) if sampler is None else sampler, pool=pool,
        telemetry=JTelemetry(),
        strategy=jstrategy(strategy),
        config=JConfig(steps_cap=4, batch_size=4, lanes_per_worker=2,
                       pipeline_depth=depth,
                       rounds_per_checkpoint=rounds_per_ckpt, **cfg),
        checkpoint_store=JStore(str(ckpt)) if ckpt else None, obs=obs)

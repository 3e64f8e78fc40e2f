"""What XLA does with the reference's ``act_shard_moe`` hook: the JAX
reference's ``_moe_dispatch(impl="scatter")`` compiled on 4 host CPU
devices laid out as (2, 2) ("data", "model"), with and without
``_mk_moe_shard(mesh)``, its weights in the reference's specs of each
policy (``fsdp_tp``: ``[E('model'), D('data'), F]`` where ``E`` divides,
``tp``: each expert's ``F`` over ``model``).  Prints, for each case, the
distinct (payload, collective) pairs of the compiled program.  It runs
the reference (JAX on the CPU), not the port:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xla_moe_shard_probe.py
"""

import os
import re

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.launch.plan import _mk_moe_shard  # noqa: E402
from repro.models import layers  # noqa: E402

D, F, T, K = 64, 128, 256, 2
COLLECTIVES = r"= (\S+) (all-gather|all-reduce|reduce-scatter|" \
              r"collective-permute)(?:-start)?\("


def specs(policy: str, E: int) -> tuple:
    """x, router, gate, up, down."""
    if policy == "tp":
        gate, down = P(None, None, "model"), P(None, "model", None)
    else:
        ep = "model" if E % 2 == 0 else None
        gate, down = P(ep, "data", None), P(ep, None, "data")
    return P("data", None), P(None, None), gate, gate, down


def main() -> None:
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    rng = np.random.default_rng(0)
    for policy, E in (("fsdp_tp", 8), ("tp", 8), ("fsdp_tp", 6)):
        args = [rng.standard_normal(s).astype(np.float32) for s in (
            (T, D), (D, E), (E, D, F), (E, D, F), (E, F, D))]
        shardings = tuple(NamedSharding(mesh, s) for s in specs(policy, E))
        for hook in (_mk_moe_shard(mesh), None):
            fn = jax.jit(lambda x, r, g, u, d, hook=hook: layers._moe_dispatch(
                x, r, g, u, d, top_k=K, impl="scatter", ep_shard=hook)[0],
                in_shardings=shardings)
            text = fn.lower(*args).compile().as_text()
            print(policy, f"E={E}", "hook" if hook else "no hook",
                  sorted(set(re.findall(COLLECTIVES, text))))


if __name__ == "__main__":
    main()

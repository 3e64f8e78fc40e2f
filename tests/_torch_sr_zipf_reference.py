"""SR at its published widths under a Zipf draw, through the reference's and
the port's ``build_engine``, on the reference's dataset and weights.

The two packages make their clients' content with different generators
(``jax.random.fold_in`` against numpy), so their own runs are not
comparable; here the port's engine is given the reference's dataset and
initial weights.  Prints one JSON line with both packages' per-round
losses.  Run on the CPU (a minute or two)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_sr_zipf_reference.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_sr_zipf_reference.py \\
        --grad-clip 1.0 --rounds 3
"""

import argparse
import json

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cohort", type=int, default=64)
    ap.add_argument("--zipf-exponent", type=float, default=1.2)
    ap.add_argument("--grad-clip", type=float, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1337)
    args = ap.parse_args(argv)

    import torch
    from repro.launch.train import build_engine as ref_build
    import repro_torch.launch.train as port_train

    kw = dict(task="sr", cohort=args.cohort, sampler="zipf",
              zipf_exponent=args.zipf_exponent, grad_clip=args.grad_clip,
              seed=args.seed, pipeline_depth=1)
    ref = ref_build(**kw)
    params = {k: np.asarray(v) for k, v in ref.params.items()}
    dataset = ref.dataset
    ref_losses = [r.loss for r in ref.run(args.rounds)]

    port_train.set_deterministic()
    port_train.make_federated_dataset = lambda task, **_: dataset
    port = port_train.build_engine(**kw, device="cpu")
    port.params = {k: torch.from_numpy(np.array(v, copy=True))
                   for k, v in params.items()}
    port_losses = [r.loss for r in port.run(args.rounds)]
    print(json.dumps({"config": kw, "reference": ref_losses,
                      "port": port_losses}))


if __name__ == "__main__":
    main()

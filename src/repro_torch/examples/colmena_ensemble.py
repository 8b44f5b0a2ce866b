"""Colmena use case (paper §III-A): ML-steered ensemble simulations.

A *Thinker* maintains a surrogate model of an unknown objective and decides
which simulation to run next; a *Task Server* (the DFK + RPEX) dispatches
heterogeneous tasks: 1-slot pre/post-processing Python functions and
multi-slot SPMD "simulations" on the pilot's rank world.  The steering
loop is genuinely sequential-in-information but pipelined: K simulations
are kept in flight, and results steer subsequent submissions — Colmena's
architecture on this runtime.

    PYTHONPATH=src python -m repro_torch.examples.colmena_ensemble [--device cpu]
"""
import math
import time

import numpy as np
import torch

from repro_torch.core import (DataFlowKernel, P, PilotDescription,
                              RPEXExecutor, pmean, python_app, shard_map,
                              spmd_app)
from repro_torch.examples import _args

TRUE_OPT = 1.7


@python_app
def pre_process(x):
    """Prepare a simulation input deck (1 CPU slot)."""
    return {"x": float(x), "deck": [float(x) ** i for i in range(4)]}


@spmd_app(slots=2, jit=False)
def simulate(mesh, deck):
    """The 'MPI simulation': distributed evaluation of an expensive
    objective at deck['x'] (noisy double-well)."""
    x = deck["x"]
    grid = torch.linspace(x - 0.1, x + 0.1, 4096, device=mesh.device)
    f = shard_map(
        lambda g: pmean(torch.mean(-(g - TRUE_OPT) ** 2
                                   - 0.05 * torch.sin(3 * g) ** 2), "data"),
        mesh=mesh, in_specs=P("data"), out_specs=P())
    val = f(grid)
    return {"x": x, "y": float(val)}


@python_app
def post_process(result, history):
    """Collect the result into the Thinker's history (1 CPU slot)."""
    return history + [(result["x"], result["y"])]


class Thinker:
    """Tiny Bayesian-flavored steering: sample-around-best with decay."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.best = (0.0, -math.inf)
        self.t = 0

    def suggest(self):
        self.t += 1
        sigma = max(0.05, 2.0 / self.t)
        return float(self.best[0] + self.rng.normal(0, sigma))

    def observe(self, history):
        for x, y in history:
            if y > self.best[1]:
                self.best = (x, y)


def main(argv=None):
    ap = _args.parser(__doc__)
    ap.add_argument("--iterations", type=int, default=24)
    ap.add_argument("--in-flight", type=int, default=4)
    args = ap.parse_args(argv)
    rpex = RPEXExecutor(PilotDescription(n_slots=8, ranks=args.ranks,
                                         devices=_args.devices(args)))
    thinker = Thinker()
    t0 = time.time()
    with DataFlowKernel(executors={"rpex": rpex}):
        live = []
        submitted = 0
        history = []
        while submitted < args.iterations or live:
            while submitted < args.iterations and len(live) < args.in_flight:
                x = thinker.suggest()
                fut = post_process(simulate(pre_process(x)), history)
                live.append(fut)
                submitted += 1
            fut = live.pop(0)
            history = fut.result()
            thinker.observe(history[-1:])
    rpex.shutdown()
    print(f"[colmena] {args.iterations} sims in {time.time()-t0:.1f}s; "
          f"best x={thinker.best[0]:.3f} (true {TRUE_OPT}) "
          f"y={thinker.best[1]:.4f}")
    assert abs(thinker.best[0] - TRUE_OPT) < 0.8
    return thinker.best


if __name__ == "__main__":
    main()

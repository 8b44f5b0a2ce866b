"""Quickstart: a heterogeneous workflow on a pilot in ~40 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a pilot whose ``spmd`` tasks run on a world of 4 rank processes,
defines three app kinds (Python, SPMD-with-collectives, bash), wires them
into a dataflow graph through futures, and runs them under the RPEX
executor — the paper's full stack (DFK -> Task Translator -> Pilot/Agent
-> SPMD function executor on the rank world).
"""
import torch

from repro_torch.core import (DataFlowKernel, P, PilotDescription,
                              RPEXExecutor, bash_app, psum, python_app,
                              shard_map, spmd_app)
from repro_torch.examples import _args


@python_app
def make_params(scale):
    return {"scale": scale}


@spmd_app(slots=4, mesh=(4, 1), jit=False)
def parallel_norm(mesh, params, n):
    """An 'MPI function': collective sum over the task's private sub-mesh."""
    x = torch.arange(float(n), device=mesh.device) * params["scale"]
    return shard_map(lambda a: psum((a * a).sum(), "data"),
                     mesh=mesh, in_specs=P("data"), out_specs=P())(x)


@python_app
def report(sq_norm):
    return f"||x||^2 = {float(sq_norm):.1f}"


@bash_app
def archive(msg):
    return f"echo archived: {msg}"


def main(argv=None):
    args = _args.parser(__doc__).parse_args(argv)
    rpex = RPEXExecutor(PilotDescription(n_slots=8, ranks=args.ranks,
                                         devices=_args.devices(args)))
    with DataFlowKernel(executors={"rpex": rpex}):
        params = make_params(2.0)          # python task
        norm = parallel_norm(params, 16)   # SPMD task, depends on params
        msg = report(norm)                 # python task, depends on norm
        arch = archive(msg)                # bash task, depends on msg
        print(msg.result())
        print(arch.result().strip())
    rpex.shutdown()
    print("executor stats:", dict(rpex.pilot.executor.stats))
    return msg.result()


if __name__ == "__main__":
    main()

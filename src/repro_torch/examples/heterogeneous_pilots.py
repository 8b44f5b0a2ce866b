"""Heterogeneous tasks on heterogeneous resources — the paper's central
claim, end to end.

One RPEXExecutor owns two pilots with distinct descriptions: a "cpu" pilot
that accepts pure-Python pre/post-processing tasks and a "device" pilot
that accepts SPMD tasks and runs them on a world of rank processes.  The
translator stamps every task's resource kind; the TaskManager late-binds
each task to a compatible pilot chosen by the executor's placement policy
— here LocalityAware, so whenever several compatible pilots could take a
task (e.g. the elastic cpu pilots of part 2), the one already holding its
input data wins.  The workflow below is the Colmena shape: per item a
Python pre-process, an SPMD simulation on the device pilot's ranks, and a
Python collector, with dataflow dependencies between them.

Part 2 demos elasticity: the same executor given PoolScaler *templates*
spawns an extra pilot when a burst of pre-processing tasks backs up the
queue (PILOT_START) — the placement policy picks the template whose kinds
match the starving queue (here the python backlog spawns the cpu
template, never the device one) — steals the backlog onto it (STOLEN),
and drains + retires it once the burst passes (PILOT_RETIRE) — watch the
event stream printed at the end.

    PYTHONPATH=src python -m repro_torch.examples.heterogeneous_pilots [--device cpu]
"""
import time

import torch

from repro_torch.core import (DataFlowKernel, PilotDescription, RPEXExecutor,
                              ScalerConfig, python_app, spmd_app)
from repro_torch.examples import _args


@python_app
def pre(i):
    return {"sim_id": i, "scale": 1.0 + 0.1 * i}


@spmd_app(slots=2, jit=False)
def simulate(mesh, spec):
    x = torch.ones(64, 64, device=mesh.device) * spec["scale"]
    y = torch.tanh(x @ x.T / 64.0)
    return {"sim_id": spec["sim_id"], "energy": float(y.sum())}


@python_app
def collect(results):
    return sorted((r["sim_id"], round(r["energy"], 3)) for r in results)


@python_app
def crunch(i):
    time.sleep(0.1)        # a burst of these overloads the cpu pilot
    return i


def main(argv=None):
    args = _args.parser(__doc__).parse_args(argv)
    cpu = [torch.device("cpu")]
    dev = _args.devices(args)
    rpex = RPEXExecutor(
        [
            PilotDescription(n_slots=4, kinds=("python", "bash"),
                             name="cpu", devices=cpu),
            PilotDescription(n_slots=8, kinds=("spmd",), name="device",
                             devices=dev, ranks=args.ranks),
        ],
        # consumers follow the pilots that hold their input data
        placement="locality",
        # elastic: spawn up to 2 extra pilots when queue wait builds,
        # retire them after ~0.5s idle; with several templates the
        # placement policy spawns the one whose kinds cover the starving
        # queue
        scaler=ScalerConfig(
            templates=[
                PilotDescription(n_slots=4, kinds=("python", "bash"),
                                 name="elastic-cpu", devices=cpu),
                PilotDescription(n_slots=8, kinds=("spmd",),
                                 name="elastic-dev", devices=dev,
                                 ranks=args.ranks),
            ],
            min_pilots=2, max_pilots=4,
            scale_up_wait_s=0.15, scale_down_idle_s=0.5,
            spawn_cooldown_s=0.3),
    )
    with DataFlowKernel(executors={"rpex": rpex}):
        sims = [simulate(pre(i)) for i in range(6)]
        table = collect(sims).result()
        print("collected:", table)
        for uid, t in rpex.tmgr.tasks.items():
            print(f"  {uid:<16} kind={t.kind:<7} res_kind={t.res_kind:<7} "
                  f"-> {t.pilot_uid}")

        # part 2: a burst that outgrows the cpu pilot -> autoscale cycle
        burst = [crunch(i) for i in range(24)]
        assert sorted(f.result() for f in burst) == list(range(24))

        # wait for the idle retire *inside* the context: exiting it shuts
        # the executor (and the scaler) down
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if any(e["event"] == "PILOT_RETIRE"
                   for e in rpex.pool.events()):
                break
            time.sleep(0.05)

    print("per-pilot utilization:", rpex.utilization())
    print("scaler decisions:")
    for d in rpex.scaler.decisions:
        print("  ", d)
    print("elastic cycle events:")
    for e in rpex.pool.events():
        if e["event"] in ("PILOT_START", "STOLEN", "PILOT_RETIRE"):
            print(f"  {e['event']:<12} {e.get('uid', '')} "
                  f"pilot={e.get('pilot', e.get('dst', ''))}")
    print("rp overhead from event stream: "
          f"{rpex.rp_overhead() * 1000:.1f} ms")
    rpex.shutdown()
    return table


if __name__ == "__main__":
    main()

"""The port's train driver on a pilot world, on the CPU: ``--data-shards``
x ``--model-shards`` > 1 starts a world of that many gloo ranks from the
driver's own process, and the run is spmd tasks on it.  Its losses and
state against the unsharded driver's, checkpoints that restore both ways,
no param or moment byte across the world's boundary, the fault drill
against an undisturbed run, and the refusals."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.store import EVENTS
from repro_torch.launch import mesh, train

MESH = ["--data-shards", "2", "--model-shards", "2"]
# the world's state against the unsharded driver's at a step, in f32 (each
# param over its change from init, each moment over itself): measured up
# to 2.5e-4 for params and 1.2e-5 for the moments on a (2, 2) mesh; a
# segment that drops its last update reads 0.39 on the params, ranks that
# all take the first rows 0.9 on everything
STATE_TOL = {"params": 1e-2, "m": 1e-3, "v": 1e-3}


def _f32(cfg):
    """The reduced config in f32: the two paths' sums then agree to f32
    rounding, so the state comparison is sharp (in bf16 one rounding of an
    update moves a param by a whole ulp)."""
    return dataclasses.replace(reduce_config(cfg), dtype="float32")


@pytest.fixture
def f32(monkeypatch):
    """The driver's ``--reduced`` config in f32 for one test (the world's
    ranks get the config by value with each task)."""
    monkeypatch.setattr(train, "reduce_config", _f32)


def _assert_same_state(ck, ref, step):
    """The checkpoints of ``ck`` and ``ref`` at ``step`` within STATE_TOL,
    after the same number of AdamW steps."""
    got = train.state_drift(_f32(get_config("smollm-360m")), ck, ref, step)
    assert got["steps"] == (step, step), got
    for k, tol in STATE_TOL.items():
        assert got[k]["worst"][0] <= tol, (k, got[k]["worst"])


def _argv(ck, steps):
    return ["--reduced", "--device", "cpu", "--steps", str(steps),
            "--segment", "2", "--batch", "4", "--seq", "32", "--ckpt-dir",
            str(ck), "--ckpt-every", "2", "--eval-every", "4"]


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The unsharded driver over 4 steps in f32, in process: its losses and
    its checkpoints' directory."""
    ck = tmp_path_factory.mktemp("plain")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "reduce_config", _f32)
        return {"losses": train.main(_argv(ck, 4)), "ck": ck}


@pytest.mark.timeout(300)
def test_train_driver_on_a_world_matches_unsharded(tmp_path, plain, f32):
    """``--data-shards 2 --model-shards 2`` on a 4-rank world, the reduced
    config in f32: its segment losses equal the unsharded driver's within
    5e-3 (the reference's own sharded check allows 5e-2), and so does its
    state: the params, AdamW moments and step in its checkpoints at steps
    2 and 4 within STATE_TOL of the unsharded run's (the losses alone, on
    a model this far from trained, hardly see a dropped update).  A
    checkpoint of either restores in the other: each resumed run starts at
    step 4, and the two agree at step 6 in loss and state."""
    sharded = train.main(_argv(tmp_path / "sharded", 4) + MESH)
    assert len(plain["losses"]) == len(sharded) == 2
    np.testing.assert_allclose(sharded, plain["losses"], atol=5e-3)
    for step in (2, 4):
        _assert_same_state(tmp_path / "sharded", plain["ck"], step)
    # the world resumes the unsharded checkpoint; and the other way
    resumed = train.main(_argv(plain["ck"], 6) + MESH)
    assert len(resumed) == 1
    back = train.main(_argv(tmp_path / "sharded", 6))
    assert len(back) == 1
    np.testing.assert_allclose(back, resumed, atol=5e-3)
    _assert_same_state(plain["ck"], tmp_path / "sharded", 6)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("flag", [["--data-shards", "2"],
                                  ["--model-shards", "2"]],
                         ids=["data", "model"])
def test_train_driver_on_a_world_of_two(tmp_path, plain, f32, flag):
    """A mesh of 2 along either axis: a 2-rank world that the driver starts
    itself, whose losses equal the unsharded driver's within 5e-3 and
    whose state at step 4 lies within STATE_TOL of it (f32)."""
    rec = {}
    losses = train.main(_argv(tmp_path, 4) + flag, rec)
    np.testing.assert_allclose(losses, plain["losses"], atol=5e-3)
    _assert_same_state(tmp_path, plain["ck"], 4)
    # the world's events read by prefix: the reference's event checker
    # scans this file too, and its registry has no world
    world = [e for e in rec["events"] if e["event"].startswith("WORLD_")]
    assert [e["event"] for e in world] == [EVENTS.WORLD_START,
                                           EVENTS.WORLD_STOP]
    assert world[0]["ranks"] == 2
    assert all(len(s["attempts"][0]["ranks"]) == 2 for s in rec["segments"])


@pytest.mark.timeout(300)
def test_train_driver_on_a_world_moves_no_state_across(tmp_path):
    """Over 6 steps in 3 segments, with a checkpoint after each and an
    evaluation at step 4: not one tensor byte crosses the world's boundary
    either way (the state is built, stepped, snapshotted, checkpointed and
    evaluated in the ranks; batches cross as numpy, metrics as floats),
    every task ran on the 4 ranks as a (2, 2) block, and each snapshot is
    freed by its last reader before the next segment ends."""
    rec = {}
    losses = train.main(_argv(tmp_path, 6) + MESH, rec)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert rec["world_stats"]["tensor_bytes_to_ranks"] == 0
    assert rec["world_stats"]["tensor_bytes_from_ranks"] == 0
    calls = rec["world_calls"]
    assert all(c["ranks"] == (0, 1, 2, 3) for c in calls)
    # init, 3 segments, 3 checkpoints and an evaluation
    assert len(calls) == 8
    held = [[r["snapshots"] for r in s["attempts"][0]["ranks"]]
            for s in rec["segments"]]
    assert held == [[1] * 4] * 3
    assert rec["recomputed"] == 0 and rec["victims"] == []


@pytest.mark.timeout(300)
def test_train_driver_on_a_world_fault_drill_matches_undisturbed(tmp_path):
    """``--inject-failure 1`` kills a rank of the segment that reaches half
    the run (steps 2 to 4): the world restarts, the driver rebuilds the
    state on it from the checkpoint of step 2 and runs steps 2 to 4 again,
    and the losses equal an undisturbed run's exactly."""
    argv = _argv(tmp_path / "drill", 6) + MESH
    rec = {}
    losses = train.main(argv + ["--inject-failure", "1"], rec)
    clean = train.main(_argv(tmp_path / "clean", 6) + MESH)
    assert losses == clean and len(losses) == 3
    assert len(rec["victims"]) == 1 and rec["recomputed"] == 2
    assert rec["rebuilt_at"] == [2]
    kinds = [e["event"] for e in rec["events"]
             if e["event"].startswith("WORLD_")]
    assert kinds == [EVENTS.WORLD_START, EVENTS.WORLD_RESTART,
                     EVENTS.WORLD_STOP]


def test_train_driver_refuses_only_what_cannot_run(tmp_path, monkeypatch):
    """A block needs as many slots as ranks, and a mesh axis at least one
    rank; without a card the default device raises rather than train on
    the CPU.  ``make_local_mesh`` still needs a running world.  A world
    whose ranks drop the block's groups after each task (the executor's
    cache off) cannot keep a state laid over them, and says so."""
    with pytest.raises(ValueError, match="needs 4 slots"):
        train.main(_argv(tmp_path, 2) + MESH + ["--slots", "3"])
    with pytest.raises(ValueError, match="at least one rank"):
        train.main(_argv(tmp_path, 2) + ["--data-shards", "0"])
    if not torch.cuda.is_available():
        argv = [a for a in _argv(tmp_path, 2) if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(argv + MESH)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_local_mesh(2, 2, device_type="cpu")
    cold = train.PilotDescription
    monkeypatch.setattr(train, "PilotDescription", lambda **kw: cold(
        **dict(kw, cache_executables=False)))
    with pytest.raises(RuntimeError, match="needs the executor's cache"):
        train.main(_argv(tmp_path / "cold", 2) + ["--data-shards", "2"])

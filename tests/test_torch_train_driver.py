"""The port's train driver on the CPU, through the runtime: the contract
of the reference's tests/test_system.py::test_train_driver_end_to_end, the
pilot tasks, the failure drill, and the refusals."""
import numpy as np
import pytest
import torch

from repro_torch.launch.train import main

ARGS = ["--arch", "smollm-360m", "--reduced", "--segment", "5", "--batch",
        "4", "--seq", "64", "--ckpt-every", "10", "--device", "cpu"]


def test_train_driver_end_to_end(tmp_path):
    ck = str(tmp_path / "ck")
    losses = main(ARGS + ["--steps", "20", "--ckpt-dir", ck,
                          "--eval-every", "20"])
    assert len(losses) == 4
    assert losses[-1] < losses[0] + 0.2      # moving in the right direction
    # restart picks up from the checkpoint
    losses2 = main(ARGS + ["--steps", "30", "--ckpt-dir", ck,
                           "--eval-every", "30"])
    assert len(losses2) == 2                 # only steps 20->30 ran


def test_train_driver_refuses_to_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    argv = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv + ["--steps", "5", "--ckpt-dir", str(tmp_path)])


def test_train_driver_runs_segments_as_pilot_tasks(tmp_path):
    """``--slots 4``: train_segment runs as an SPMD task on 2 slots beside
    the evaluate and commit_checkpoint Python tasks, in the pilot."""
    run = {}
    losses = main(ARGS + ["--steps", "10", "--ckpt-dir", str(tmp_path),
                          "--eval-every", "5", "--slots", "4"], run)
    assert len(losses) == 2 and all(np.isfinite(losses))
    seg_uids = [s["uid"] for s in run["segments"]]
    assert len(set(seg_uids)) == 2 and run["victims"] == []
    assert all(len(s["attempts"]) == 1 and s["attempts"][0]["steps_run"] == 5
               for s in run["segments"])
    done = {(e["uid"], e["kind"], e["slots"]) for e in run["events"]
            if e.get("event") == "STATE" and e["state"] == "DONE"}
    assert {(u, "spmd", 2) for u in seg_uids} <= done
    # a commit (step 10) and 2 evaluations (steps 5 and 10), one slot each
    assert sum(1 for _, kind, n in done if kind == "python" and n == 1) == 3


def test_train_driver_inject_failure_finishes_every_step(tmp_path):
    """``--inject-failure 1`` fails a slot of the running segment: that
    segment is retried on the slots left, resumes from its last saved
    step, and the run matches one without the failure step for step; a
    restart then runs only the remaining steps (the reference's contract,
    tests/test_system.py::test_train_driver_end_to_end)."""
    ck = str(tmp_path / "ck")
    argv = ARGS + ["--steps", "20", "--eval-every", "20"]
    run = {}
    losses = main(argv + ["--ckpt-dir", ck, "--inject-failure", "1"], run)
    assert len(losses) == 4 and len(run["victims"]) == 1
    hit = [s for s in run["segments"] if s["uid"] in run["victims"]]
    assert len(hit) == 1 and [a["steps_run"] for a in hit[0]["attempts"]] \
        == [5, 0]                           # the retry applied no step twice
    clean = main(argv + ["--ckpt-dir", str(tmp_path / "clean")])
    assert losses == clean
    losses2 = main(ARGS + ["--steps", "30", "--ckpt-dir", ck,
                           "--eval-every", "30"])
    assert len(losses2) == 2                 # only steps 20->30 ran


@pytest.mark.parametrize("flag", [["--data-shards", "2"],
                                  ["--model-shards", "2"]])
def test_train_driver_raises_on_what_is_not_ported(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="item 13"):
        main(ARGS + ["--steps", "5", "--ckpt-dir", str(tmp_path)] + flag)

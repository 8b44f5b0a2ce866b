"""The port's train driver on the CPU, through the runtime: the contract
of the reference's tests/test_system.py::test_train_driver_end_to_end, the
pilot tasks, the failure drill, and the refusal to fall back to the CPU.
The driver on a pilot world (a mesh) is tests/test_torch_train_world.py."""
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


def test_train_driver_trains_the_vlm_with_patches(tmp_path):
    """``--arch internvl2-76b --reduced``: the data pipeline adds 4 patch
    positions in front of each sequence (``frontend_tokens``), and they go
    through the pilot's segments to ``loss_fn``; the patches reach the loss
    (the connector's second moment in the checkpoint is nonzero) and the
    checkpoint holds the connector."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch.train import build_state, checkpoint_tree
    from repro_torch.models import model as M

    seen = []
    real = M.loss_fn

    def spy(cfg, params, batch, *a, **kw):
        seen.append((tuple(batch["tokens"].shape),
                     tuple(batch["patches"].shape), batch["patches"].dtype))
        return real(cfg, params, batch, *a, **kw)

    ck = str(tmp_path / "ck")
    M.loss_fn = spy
    try:
        losses = main(["--arch", "internvl2-76b", "--reduced", "--segment",
                       "2", "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--steps", "4", "--ckpt-every", "4", "--eval-every",
                       "4", "--ckpt-dir", ck])
    finally:
        M.loss_fn = real
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = reduce_config(get_config("internvl2-76b"))
    # 4 train steps and one evaluation, each with 4 patch positions
    assert len(seen) == 5
    assert set(seen) == {((2, 16), (2, 4, cfg.d_model), torch.float32)}
    params, _, opt_state = build_state(cfg, torch.device("cpu"))
    step, (saved_p, saved, _) = Checkpointer(ck).restore(
        checkpoint_tree(cfg, params, opt_state, 0))
    assert step == 4
    assert saved_p["connector"]["wi"].dtype == torch.bfloat16
    for name in ("wi", "wo"):
        assert float(saved.v["connector"][name].abs().max()) > 0


def test_train_driver_trains_mamba2_and_resumes(tmp_path):
    """``--arch mamba2-1.3b --reduced``: the SSD backward on the CPU route
    (K2b's plain version), 10 steps in 2 segments through the pilot, the
    losses finite, every parameter's gradient in AdamW's state, each
    segment's K2 and K2b launch counts unchanged (no kernel on the CPU),
    and a restart from the checkpoint that runs only the remaining steps.

    The losses do not show learning here: each is one step's loss on its
    own batch while the learning rate warms up over 20 steps, and batch to
    batch they move by more than ten steps of training do.  Over 30 steps
    they stay between 5.58 and 5.73 for this arch, the port's smollm and
    the reference's own driver alike.  So the test holds the last loss
    under the first plus 0.2, and proves the gradients flow from AdamW's
    state."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch.train import build_state, checkpoint_tree

    ck = str(tmp_path / "ck")
    argv = ["--arch", "mamba2-1.3b", "--reduced", "--segment", "5",
            "--batch", "4", "--seq", "64", "--device", "cpu",
            "--ckpt-every", "10", "--ckpt-dir", ck]
    run = {}
    losses = main(argv + ["--steps", "10", "--eval-every", "10"], run)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] + 0.2
    # AdamW's second moment starts at 0 and gains only g^2: after 10
    # steps every leaf's holds a nonzero entry in every layer, so each
    # parameter had a gradient (the SSD's A_log, dt_bias and D, and the
    # in_proj that feeds x, B, C and dt, included)
    cfg = reduce_config(get_config("mamba2-1.3b"))
    params, _, opt_state = build_state(cfg, torch.device("cpu"))
    step, (_, saved, _) = Checkpointer(ck).restore(
        checkpoint_tree(cfg, params, opt_state, 0))
    assert step == 10

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    seen = [path for path, _ in leaves(saved.v)]
    assert any(p.endswith("/A_log") for p in seen) \
        and any(p.endswith("/dt_bias") for p in seen)
    for path, v in leaves(saved.v):
        if path.startswith("/layers/"):       # stacked: (layers, ...)
            per_layer = v.float().abs().flatten(1).amax(dim=1)
            assert bool((per_layer > 0).all()), path
        else:
            assert float(v.float().abs().max()) > 0, path
    for seg in run["segments"]:
        for attempt in seg["attempts"]:
            assert attempt["launches"]["ssd_chunk_kernel"] == 0
            assert attempt["launches"]["ssd_chunk_bwd_kernel"] == 0
    losses2 = main(argv + ["--steps", "15", "--eval-every", "15"])
    assert len(losses2) == 1 and np.isfinite(losses2[0])

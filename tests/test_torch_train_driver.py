"""The port's train driver on the CPU: the contract of the reference's
tests/test_system.py::test_train_driver_end_to_end, and the refusals."""
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


@pytest.mark.parametrize("flag,item", [
    (["--slots", "4"], "item 7"),
    (["--inject-failure", "1"], "item 7"),
    (["--data-shards", "2"], "item 13"),
    (["--model-shards", "2"], "item 13"),
])
def test_train_driver_raises_on_what_is_not_ported(tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=item):
        main(ARGS + ["--steps", "5", "--ckpt-dir", str(tmp_path)] + flag)
